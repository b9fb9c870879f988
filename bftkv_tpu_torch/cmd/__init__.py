"""Process entry points of the port (``python -m bftkv_tpu_torch.cmd.<name>``)."""
