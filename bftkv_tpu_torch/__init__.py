"""bftkv_tpu_torch — the PyTorch/CUDA port of bftkv_tpu's crypto plane.

The port lives beside the JAX package and mirrors its module layout
(``ops/rns.py`` ↔ ``bftkv_tpu/ops/rns.py`` and so on), so the counterpart
of every module is found by name.  It imports ``torch`` and numpy only,
never ``jax`` nor ``bftkv_tpu``: what it needs of the reference's
host-side math it keeps as its own copy.

Entry points take an explicit ``device``: ``"cuda"`` (the default) runs
the hand-written Hopper kernels under ``ops/csrc/``; ``"cpu"`` runs
their plain PyTorch versions and exists for tests.  Asking for CUDA on a
machine without it raises — nothing carries on silently on the CPU.
"""

__all__ = ["crypto", "device", "flags", "metrics", "ops"]
