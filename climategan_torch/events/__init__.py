"""The wildfire and smog events of the port (NCHW, float32)."""
