"""Runnable examples of the port (``python -m
dmlc_tpu_torch.examples.<name>``)."""
