"""Batch pipeline (host wire + device synthesis) and the corpus decode."""
