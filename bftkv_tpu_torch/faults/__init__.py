"""Fault injection of the port (counterpart of ``bftkv_tpu/faults``):
:mod:`bftkv_tpu_torch.faults.failpoint`, the seeded failpoint registry."""
