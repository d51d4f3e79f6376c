"""Models of the port: configs, layers, the DiT experts and router, and
the Mamba2 LM backbone with its zoo dispatch."""
