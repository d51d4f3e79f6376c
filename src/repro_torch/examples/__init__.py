"""The port's examples, run as modules (``python -m
repro_torch.examples.<name>``)."""
