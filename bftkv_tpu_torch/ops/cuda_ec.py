"""Wrapper of the P-256 scalar-mult kernel (counterpart of the reference's
jitted ``bftkv_tpu/ops/ec_rns.py::_scalar_mult_fn``, an XLA program with no
Pallas form).

- :func:`scalar_mult_cuda` — K5, ``csrc/ec_p256.cu::ec_scalar_mult_kernel``:
  the whole RNS scalar mult (window table, 64 windows, final accumulator)
  in one launch.

It takes device tensors: the staged (3, 2k+1, T) int32 Montgomery
residues of the points, the (64, T) uint8 window values of the scalars
(most significant first) and the engine of :mod:`ops.ec_rns`, whose
context constants (``cn.kern``), P-256 key rows (``ukey``) and field
table (``field``) the kernel reads.  For CUDA tensors it launches the
kernel on the current stream or raises; for CPU tensors — and only for
them — it runs the plain version,
:func:`bftkv_tpu_torch.ops.ec_rns._scalar_mult`.

:data:`LAUNCHES` counts kernel launches; nothing else moves it.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from bftkv_tpu_torch.ops import _build, idle

__all__ = ["LAUNCHES", "kernel_attrs", "reset_launches", "scalar_mult_cuda"]

NWIN = 64

#: Kernel launches ("ec_scalar_mult" = K5).
LAUNCHES = {"ec_scalar_mult": 0}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        LAUNCHES["ec_scalar_mult"] = 0


def kernel_attrs() -> dict[str, dict[str, int]]:
    """Registers and local-memory bytes per thread of K5 as built for
    ``cuda:0``, its points per block (one group of 8, the mma's N) and the
    blocks an SM holds at once."""
    lib = _build.library()
    regs, local, pts, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(0):
        rc = lib.ec_kernel_attrs(ctypes.byref(regs), ctypes.byref(local), ctypes.byref(pts),
                                 ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(
            f"ec_scalar_mult kernel attributes: {lib.rns_error_string(rc).decode()} ({rc})"
        )
    return {"ec_scalar_mult": {"registers": regs.value, "local_bytes": local.value,
                               "points_per_block": pts.value, "blocks_per_sm": blocks.value}}


def _check(res: torch.Tensor, nib: torch.Tensor, eng) -> None:
    if res.dtype != torch.int32 or nib.dtype != torch.uint8:
        raise TypeError(f"dtypes res {res.dtype}, nib {nib.dtype}: expected int32, uint8")
    k = eng.k
    t = res.shape[-1] if res.dim() == 3 else -1
    if res.dim() != 3 or tuple(res.shape[:2]) != (3, 2 * k + 1) or t < 1:
        raise ValueError(f"res: shape {tuple(res.shape)}, expected (3, {2 * k + 1}, T >= 1)")
    if tuple(nib.shape) != (NWIN, t):
        raise ValueError(f"nib: shape {tuple(nib.shape)}, expected ({NWIN}, {t})")
    for name, a in (("res", res), ("nib", nib)):
        if a.device != res.device:
            raise ValueError(f"{name}: on {a.device}, expected {res.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    if eng.field.device != res.device:
        raise ValueError(f"engine constants on {eng.field.device}, operands on {res.device}")


def _launch(res: torch.Tensor, nib: torch.Tensor, eng, out: torch.Tensor) -> torch.Tensor:
    """Launches K5 into ``out``, a contiguous (3, 2k+1, T) int32 tensor on the
    operands' device that the caller allocates; the kernel writes its
    columns below T and nothing else."""
    if (out.dtype != torch.int32 or out.shape != res.shape or out.device != res.device
            or not out.is_contiguous()):
        raise ValueError(f"out: {out.dtype} {tuple(out.shape)} on {out.device}")
    cn = eng.cn
    kc = cn.kern
    lib = _build.library()
    need, limit = ctypes.c_int(), ctypes.c_int()
    # The launcher sets the kernel's shared-memory attribute on the current
    # device and launches there: make it the operands' card.
    with torch.cuda.device(res.device):
        rc = lib.ec_scalar_mult_launch(
            res.data_ptr(), nib.data_ptr(), res.shape[1], res.shape[2],
            *(u.data_ptr() for u in eng.ukey[:3]),
            *(kc[n].data_ptr() for n in (
                "p_all", "invMi_b", "invMi_q", "Mq_mod_b", "invM_q",
                "mu_all", "invMi_b_sh", "Mq_mod_b_sh", "invM_q_sh", "E_mma",
            )),
            eng.field.data_ptr(), cn.invMq_pr, cn.invM_pr, cn.k,
            out.data_ptr(), torch.cuda.current_stream(res.device).cuda_stream,
            ctypes.byref(need), ctypes.byref(limit), *idle.kernel_events(),
        )
    if rc == _build.ERR_SHARED_MEMORY:
        raise RuntimeError(
            f"ec_scalar_mult kernel needs {need.value} bytes of shared memory per block; "
            f"the device allows {limit.value}"
        )
    if rc != 0:
        raise RuntimeError(
            f"ec_scalar_mult kernel launch failed: {lib.rns_error_string(rc).decode()} ({rc})"
        )
    with _count_lock:
        LAUNCHES["ec_scalar_mult"] += 1
    return out


def scalar_mult_cuda(res: torch.Tensor, nib: torch.Tensor, eng) -> torch.Tensor:
    """K5: (3, 2k+1, T) int32 Jacobian Montgomery residues of k·P per column."""
    _check(res, nib, eng)
    if res.device.type == "cpu":
        from bftkv_tpu_torch.ops import ec_rns

        return ec_rns._scalar_mult(eng, res, nib)
    if res.device.type != "cuda":
        raise ValueError(f"unsupported device {res.device}")
    return _launch(res, nib, eng, torch.empty_like(res))
