"""Device stages of the port: each kernel's wrapper and its plain twin."""
