"""The training data pipeline of the port: file lists, decoding, host-side
transforms (numpy) and loaders."""
