"""Crypto domains of the port (counterpart of ``bftkv_tpu/crypto``)."""
