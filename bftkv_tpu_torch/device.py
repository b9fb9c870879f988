"""Device resolution for the port's entry points.

Replaces the reference's JAX-only ``hostcpu.force_cpu`` and
``ops.enable_compile_cache``: every entry point takes ``device`` and
resolves it here.  ``None`` means ``cuda:0``; ``"cpu"`` is honoured only
when asked for.  Asking for CUDA where there is none raises
``RuntimeError`` — there is no quiet fallback to the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["DEFAULT", "resolve"]

DEFAULT = "cuda:0"


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The ``torch.device`` an entry point runs on."""
    dev = torch.device(DEFAULT if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise RuntimeError(f"unsupported device {str(dev)!r} (cuda or cpu)")
