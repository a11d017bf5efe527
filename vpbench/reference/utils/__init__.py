"""Host helpers of the plain reference."""
