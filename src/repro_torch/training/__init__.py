"""Checkpoint I/O of the port (the training side is still to port)."""
