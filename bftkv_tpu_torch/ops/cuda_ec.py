"""Wrapper of the P-256 scalar-mult kernel (counterpart of the reference's
jitted ``bftkv_tpu/ops/ec_rns.py::_scalar_mult_fn``, an XLA program with no
Pallas form).

- :func:`scalar_mult_cuda` — K5, ``csrc/ec_p256.cu::ec_scalar_mult_kernel``:
  the whole RNS scalar mult (window table, 64 windows, final accumulator)
  in one launch.

It takes device tensors: the staged (3, 2k+1, T) int32 Montgomery
residues of the points, the (64, T) uint8 window values of the scalars
(most significant first) and the engine of :mod:`ops.ec_rns`, whose
``lane`` table holds the kernel's constants.  For CUDA tensors it
launches the kernel on the current stream or raises; for CPU tensors —
and only for them — it runs the plain version,
:func:`bftkv_tpu_torch.ops.ec_rns._scalar_mult`.

:data:`LAUNCHES` counts kernel launches; nothing else moves it.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from bftkv_tpu_torch.ops import _build

__all__ = ["LAUNCHES", "kernel_attrs", "reset_launches", "scalar_mult_cuda"]

NWIN = 64

#: Kernel launches ("ec_scalar_mult" = K5).
LAUNCHES = {"ec_scalar_mult": 0}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        LAUNCHES["ec_scalar_mult"] = 0


def kernel_attrs() -> dict[str, dict[str, int]]:
    """Registers and local-memory bytes per thread of K5 as built, and its
    points (warps) per block."""
    lib = _build.library()
    regs, local, pts = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.ec_kernel_attrs(ctypes.byref(regs), ctypes.byref(local), ctypes.byref(pts))
    if rc != 0:
        raise RuntimeError(
            f"ec_scalar_mult kernel attributes: {lib.rns_error_string(rc).decode()} ({rc})"
        )
    return {"ec_scalar_mult": {"registers": regs.value, "local_bytes": local.value,
                               "points_per_block": pts.value}}


def _check(res: torch.Tensor, nib: torch.Tensor, lane: torch.Tensor) -> None:
    from bftkv_tpu_torch.ops import ec_rns

    if res.dtype != torch.int32 or nib.dtype != torch.uint8 or lane.dtype != torch.int32:
        raise TypeError(
            f"dtypes res {res.dtype}, nib {nib.dtype}, lane {lane.dtype}: "
            "expected int32, uint8, int32"
        )
    t = res.shape[-1] if res.dim() == 3 else -1
    k = (lane.shape[0] - len(ec_rns.LANE_ROWS)) // 2
    if res.dim() != 3 or tuple(res.shape[:2]) != (3, 2 * k + 1) or t < 1:
        raise ValueError(f"res: shape {tuple(res.shape)}, expected (3, {2 * k + 1}, T >= 1)")
    if tuple(nib.shape) != (NWIN, t):
        raise ValueError(f"nib: shape {tuple(nib.shape)}, expected ({NWIN}, {t})")
    if tuple(lane.shape) != (len(ec_rns.LANE_ROWS) + 2 * k, ec_rns.LANES):
        raise ValueError(f"lane: shape {tuple(lane.shape)}")
    for name, a in (("res", res), ("nib", nib), ("lane", lane)):
        if a.device != res.device:
            raise ValueError(f"{name}: on {a.device}, expected {res.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name}: not contiguous")


def scalar_mult_cuda(res: torch.Tensor, nib: torch.Tensor, eng) -> torch.Tensor:
    """K5: (3, 2k+1, T) int32 Jacobian Montgomery residues of k·P per column."""
    _check(res, nib, eng.lane)
    if res.device.type == "cpu":
        from bftkv_tpu_torch.ops import ec_rns

        return ec_rns._scalar_mult(eng, res, nib)
    if res.device.type != "cuda":
        raise ValueError(f"unsupported device {res.device}")
    out = torch.empty_like(res)
    lib = _build.library()
    rc = lib.ec_scalar_mult_launch(
        res.data_ptr(), nib.data_ptr(), eng.lane.data_ptr(), res.shape[1], res.shape[2],
        out.data_ptr(), torch.cuda.current_stream(res.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"ec_scalar_mult kernel launch failed: {lib.rns_error_string(rc).decode()} ({rc})"
        )
    with _count_lock:
        LAUNCHES["ec_scalar_mult"] += 1
    return out
