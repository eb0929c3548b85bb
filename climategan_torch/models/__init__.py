"""Model modules of the port (NCHW)."""
