"""Development-time correctness tooling of the port (counterpart of
``bftkv_tpu/devtools``): :mod:`bftkv_tpu_torch.devtools.lockwatch`."""
