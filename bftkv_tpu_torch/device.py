"""Device resolution for the port's entry points.

Replaces the reference's JAX-only ``hostcpu.force_cpu`` and
``ops.enable_compile_cache``: every entry point takes ``device`` and
resolves it here.  ``None`` means ``cuda:0``; ``"cpu"`` is honoured only
when asked for.  Asking for CUDA where there is none raises
``RuntimeError`` — there is no quiet fallback to the CPU.

:func:`stream` hands each thread its own CUDA streams, one per (card,
lane): a flush worker that splits a launch over several cards (or
several shards of one card) runs each shard on its own stream.
"""

from __future__ import annotations

import threading

import torch

__all__ = ["DEFAULT", "resolve", "stream"]

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


_streams = threading.local()


def stream(dev: torch.device, lane: int) -> torch.cuda.Stream:
    """The calling thread's CUDA stream number ``lane`` on the card ``dev``,
    created on first use and kept for the thread's life."""
    table = getattr(_streams, "table", None)
    if table is None:
        table = _streams.table = {}
    key = (dev.index, lane)
    s = table.get(key)
    if s is None:
        s = table[key] = torch.cuda.Stream(dev)
    return s
