"""Wrappers of the fused RNS chains (counterpart of ``ops/pallas_rns.py``).

- :func:`verify_cuda` — K1, ``csrc/rns_chain.cu::rns_verify_kernel``,
  replaces ``pallas_rns.py::_verify_body`` (entry ``verify_pallas``);
- :func:`pow_cuda` — K2, ``csrc/rns_pow.cu::rns_pow_kernel``, replaces
  ``pallas_rns.py::_pow_body`` (entry ``pow_pallas``).

Both run their RNS Montgomery products through one device
implementation, ``csrc/rns_mma.cuh``, and take the same arguments.

Each takes device tensors: the (T, ·) operands, the (T,) key index, the
(K, ·) int32 unique key rows of :func:`rns.key_rows_from_numpy` and
the :class:`rns._Consts` of the context.  For CUDA tensors it launches
the kernel on the current stream (gathering the key rows through
``idx`` inside the kernel, which clamps an index outside [0, K) to keep
its reads in bounds and fails such a verify row closed; the entry
points refuse such indices) or raises; for CPU tensors — and only for
them — it runs the plain PyTorch version in
:mod:`bftkv_tpu_torch.ops.rns`.

:data:`LAUNCHES` counts kernel launches; nothing else moves it.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from bftkv_tpu_torch.ops import _build
from bftkv_tpu_torch.ops import rns

__all__ = ["LAUNCHES", "kernel_attrs", "pow_cuda", "reset_launches", "verify_cuda"]

#: Kernel launches per wrapper ("verify" = K1, "pow" = K2).
LAUNCHES = {"verify": 0, "pow": 0}
_count_lock = threading.Lock()

#: The launchers' code for "the block's shared memory does not fit the card".
_ERR_SHARED_MEMORY = -2

def reset_launches() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def kernel_attrs() -> dict[str, dict[str, int]]:
    """Registers and local-memory bytes per thread of each kernel as built,
    and its rows per block."""
    lib = _build.library()
    out = {}
    for name, fn in (("verify", lib.rns_verify_attrs), ("pow", lib.rns_pow_attrs)):
        regs, local, rows = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = fn(ctypes.byref(regs), ctypes.byref(local), ctypes.byref(rows))
        if rc != 0:
            raise RuntimeError(
                f"rns {name} kernel attributes: {lib.rns_error_string(rc).decode()} ({rc})"
            )
        out[name] = {"registers": regs.value, "local_bytes": local.value,
                     "rows_per_block": rows.value}
    return out


def _check(t: torch.Tensor, name: str, dtype, shape, dev) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, expected {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _launch(which: str, a, b, idx, ukey, cn, out: torch.Tensor) -> torch.Tensor:
    """Launches K1 (``which="verify"``) or K2 into ``out``, which the
    caller allocates: (T,) or (T, k) int32 on the operands' device."""
    dev = a.device
    if cn.device != dev:
        raise ValueError(f"constants on {cn.device}, operands on {dev}")
    k, digits = cn.k, cn.digits
    t = a.shape[0]
    n_keys = ukey[0].shape[0]
    for u, w, name in zip(
        ukey, (2 * k, 1, k, 2 * k, 2 * k, 1),
        ("n_all", "n_r", "neg_ninv_b", "ninv_all", "m2_all", "m2_r"),
    ):
        _check(u, name, torch.int32, (n_keys, w), dev)
    _check(a, "halves", torch.uint8, (t, 2 * digits), dev)
    if which == "verify":
        _check(b, "em_halves", torch.uint8, (t, 2 * digits), dev)
        _check(out, "out", torch.int32, (t,), dev)
    else:
        _check(b, "nibbles", torch.uint8, (4 * digits, t), dev)
        _check(out, "out", torch.int32, (t, k), dev)
    _check(idx, "idx", torch.int32, (t,), dev)
    if t == 0 or n_keys == 0:
        raise ValueError(f"empty launch: {t} rows, {n_keys} key rows")
    kc = cn.kern
    lib = _build.library()
    fn = lib.rns_verify_launch if which == "verify" else lib.rns_pow_launch
    need, limit = ctypes.c_int(), ctypes.c_int()
    rc = fn(
        a.data_ptr(), b.data_ptr(), idx.data_ptr(), t, n_keys,
        *(u.data_ptr() for u in ukey),
        *(kc[n].data_ptr() for n in (
            "p_all", "invMi_b", "invMi_q", "Mq_mod_b", "invM_q",
            "mu_all", "invMi_b_sh", "invMi_q_sh", "Mq_mod_b_sh", "invM_q_sh", "E_mma", "D",
        )),
        cn.invMq_pr, cn.invM_pr, k, digits,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        ctypes.byref(need), ctypes.byref(limit),
    )
    if rc == _ERR_SHARED_MEMORY:
        raise RuntimeError(
            f"rns {which} kernel at k={k}, {digits} digits needs {need.value} bytes "
            f"of shared memory per block; the device allows {limit.value}"
        )
    if rc != 0:
        raise RuntimeError(
            f"rns {which} kernel launch failed: "
            f"{lib.rns_error_string(rc).decode()} ({rc})"
        )
    with _count_lock:
        LAUNCHES[which] += 1
    return out


def verify_cuda(sig_h, em_h, idx, ukey, cn) -> torch.Tensor:
    """K1: (T,) bool, s^65537 ≡ em (mod N) per row."""
    if sig_h.device.type == "cpu":
        return rns._verify_kernel(cn, sig_h, em_h, rns.gather_key(ukey, idx))
    if sig_h.device.type != "cuda":
        raise ValueError(f"unsupported device {sig_h.device}")
    out = torch.empty(sig_h.shape[0], dtype=torch.int32, device=sig_h.device)
    return _launch("verify", sig_h, em_h, idx, ukey, cn, out) != 0


def pow_cuda(base_h, nib_t, idx, ukey, cn) -> torch.Tensor:
    """K2: (T, k) CRT coefficients σ over B of base^exp mod N per row."""
    if base_h.device.type == "cpu":
        return rns._pow_kernel(cn, base_h, nib_t, rns.gather_key(ukey, idx))
    if base_h.device.type != "cuda":
        raise ValueError(f"unsupported device {base_h.device}")
    out = torch.empty((base_h.shape[0], cn.k), dtype=torch.int32, device=base_h.device)
    return _launch("pow", base_h, nib_t, idx, ukey, cn, out)
