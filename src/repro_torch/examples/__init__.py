"""Runnable examples of the port (counterparts of the repo's ``examples/``):
``python -m repro_torch.examples.<name>``."""
