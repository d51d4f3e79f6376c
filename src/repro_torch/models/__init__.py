"""DiT expert/router models of the port (config, layers, DiT)."""
