"""Wrapper of the limb-Montgomery verify chain (counterpart of ``ops/pallas_mont.py``).

- :func:`verify_cuda` — K3, ``csrc/mont_chain.cu::mont_verify_kernel``,
  replaces ``pallas_mont.py::_verify_kernel`` (entry ``verify_e65537``).

Operands are five ``(T, 128)`` int32 tensors of 16-bit digits (sig, em,
n, n', r2), T a multiple of 256 — the reference's tile; it leaves rows
past the last whole tile unwritten, the port refuses such a T.  For CUDA
tensors :func:`verify_diff` launches the kernel on the current stream or
raises; for CPU tensors — and only for them — it runs the plain version,
:func:`bftkv_tpu_torch.ops.rsa._verify_chain`.

:data:`LAUNCHES` counts kernel launches; nothing else moves it.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from bftkv_tpu_torch.ops import _build, idle

__all__ = ["LAUNCHES", "ROWS_PER_BLOCK", "THREADS_PER_ROW", "TILE", "kernel_attrs",
           "reset_launches", "verify_cuda", "verify_diff"]

L = 128  # 16-bit digits of a 2048-bit number: the kernel is 2048-bit only
TILE = 256  # rows per tile of the reference kernel
# The kernel's layout, as ``csrc/mont_chain.cu`` sets it (``kTpi``, and
# ``kThreads / kTpi``): each row's products are split across a group of
# THREADS_PER_ROW lanes of one warp, ROWS_PER_BLOCK rows per block.
THREADS_PER_ROW = 16
ROWS_PER_BLOCK = 8

#: Kernel launches ("mont_verify" = K3).
LAUNCHES = {"mont_verify": 0}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        LAUNCHES["mont_verify"] = 0


def kernel_attrs() -> dict[str, dict[str, int]]:
    """Registers and local-memory bytes per thread of K3 as built for
    ``cuda:0``, beside its threads per row and rows per block."""
    lib = _build.library()
    regs, local = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(0):
        rc = lib.mont_kernel_attrs(ctypes.byref(regs), ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(
            f"mont_verify kernel attributes: {lib.rns_error_string(rc).decode()} ({rc})"
        )
    return {"mont_verify": {"registers": regs.value, "local_bytes": local.value,
                            "threads_per_row": THREADS_PER_ROW,
                            "rows_per_block": ROWS_PER_BLOCK}}


def _check(ops) -> None:
    t = ops[0].shape[0]
    dev = ops[0].device
    for name, a in zip(("sig", "em", "n", "nprime", "r2"), ops):
        if a.dtype != torch.int32:
            raise TypeError(f"{name}: dtype {a.dtype}, expected torch.int32")
        if tuple(a.shape) != (t, L):
            raise ValueError(f"{name}: shape {tuple(a.shape)}, expected ({t}, {L})")
        if a.device != dev:
            raise ValueError(f"{name}: on {a.device}, expected {dev}")
        if not a.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    if t == 0 or t % TILE:
        raise ValueError(f"{t} rows: the batch must be a positive multiple of {TILE}")


def verify_diff(sig, em, n, nprime, r2) -> torch.Tensor:
    """K3: (T, 128) int32 ``v XOR em`` with v = sig^65537 mod n per row."""
    ops = (sig, em, n, nprime, r2)
    _check(ops)
    if sig.device.type == "cpu":
        from bftkv_tpu_torch.ops import rsa

        return rsa._verify_chain(*(a.long() for a in ops)).to(torch.int32)
    if sig.device.type != "cuda":
        raise ValueError(f"unsupported device {sig.device}")
    out = torch.empty_like(sig)
    lib = _build.library()
    stream = torch.cuda.current_stream(sig.device).cuda_stream
    with torch.cuda.device(sig.device):  # launch on the operands' card
        rc = lib.mont_verify_launch(
            sig.data_ptr(), em.data_ptr(), n.data_ptr(), nprime.data_ptr(),
            r2.data_ptr(), sig.shape[0], out.data_ptr(), stream, *idle.kernel_events(),
        )
    if rc != 0:
        raise RuntimeError(
            f"mont_verify kernel launch failed: {lib.rns_error_string(rc).decode()} ({rc})"
        )
    with _count_lock:
        LAUNCHES["mont_verify"] += 1
    return out


def verify_cuda(sig, em, n, nprime, r2) -> torch.Tensor:
    """K3: (T,) bool, sig^65537 mod n == em per row."""
    return (verify_diff(sig, em, n, nprime, r2) == 0).all(dim=-1)
