"""Builds the hand-written CUDA kernels at first use.

``torch.utils.cpp_extension.load`` compiles ``csrc/rns_chain.cu`` (K1),
``csrc/rns_pow.cu`` (K2), ``csrc/mont_chain.cu`` (K3) and ``csrc/ec_p256.cu``
(K5) from this checkout for ``sm_90a``
(K1, K2 and K5 include ``csrc/rns_mma.cuh``, their shared Montgomery product)
into one library under ``bftkv_tpu_torch/_build/`` (listed in
``.gitignore``) and loads it; ninja runs one ``nvcc`` per source, in
parallel.  The sources have a plain C interface and include no PyTorch
header, so the build takes seconds; the library is loaded with
``ctypes`` (``is_python_module=False``).  Each launcher takes two
optional CUDA events that it records on the stream right around its
kernel (:func:`~bftkv_tpu_torch.ops.idle.kernel_events`).  The build runs
under a lock because dispatcher threads race to the first launch; a
build error raises — there is no fallback to the plain versions.
"""

from __future__ import annotations

import ctypes
import os
import threading

__all__ = ["BUILD_DIR", "ERR_SHARED_MEMORY", "bind", "build", "library", "load"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_HERE, "csrc", name)
           for name in ("rns_chain.cu", "rns_pow.cu", "mont_chain.cu", "ec_p256.cu")]
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build", "kernels")
CUDA_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a"]

#: The RNS launchers' return code (rns_mma::kErrSharedMemory) for "the
#: block's shared memory does not fit the card"; any other nonzero code is
#: a cudaError_t value.
ERR_SHARED_MEMORY = -2

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
# K1 and K2: (halves, em_halves | nibbles, idx, T, n_keys, 6 key-row
#  arrays, 5 channel vectors, mu_all and 3 Shoup vectors, E_mma, D,
#  invMq_pr, invM_pr, k, digits, out, stream, smem_need, smem_limit, and the
#  events recorded around the kernel)
_LAUNCH_ARGS = ([_P, _P, _P, _I, _I] + [_P] * 6 + [_P] * 9 + [_P] * 2 + [_I] * 4
                + [_P, _P] + [ctypes.POINTER(_I)] * 2 + [_P, _P])

# K5: (res, nib, chan, T, 3 key-row arrays, 5 channel vectors, mu_all and 3
#  Shoup vectors, E_mma, field, invMq_pr, invM_pr, k, out, stream,
#  smem_need, smem_limit, and the events recorded around the kernel)
_EC_LAUNCH_ARGS = ([_P, _P, _I, _I] + [_P] * 3 + [_P] * 9 + [_P, _P] + [_I] * 3
                   + [_P, _P] + [ctypes.POINTER(_I)] * 2 + [_P, _P])


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load()
        return _lib


def build(name: str, build_dir: str, sources: list[str] = SOURCES,
          defines: tuple[str, ...] = ()) -> str:
    """Compiles ``sources`` (with extra ``-D`` ``defines``) into a shared
    library under ``build_dir``; returns its path."""
    from torch.utils import cpp_extension

    os.makedirs(build_dir, exist_ok=True)
    return cpp_extension.load(
        name=name,
        sources=sources,
        extra_cuda_cflags=CUDA_FLAGS + [f"-D{d}" for d in defines],
        build_directory=build_dir,
        is_python_module=False,
    )


def load(name: str = "bftkv_kernels", build_dir: str = BUILD_DIR,
         defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Builds the sources into ``build_dir`` (with extra ``-D`` ``defines``,
    for a timing comparison of a compile-time variant) and loads them."""
    return bind(ctypes.CDLL(build(name, build_dir, defines=defines)))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of the kernel library ``lib``."""
    for fn in (lib.rns_verify_launch, lib.rns_pow_launch):
        fn.argtypes = _LAUNCH_ARGS
        fn.restype = ctypes.c_int
    for fn in (lib.rns_verify_attrs, lib.rns_pow_attrs):
        fn.argtypes = [ctypes.POINTER(_I)] * 3
        fn.restype = ctypes.c_int
    # (sig, em, n, nprime, r2, T, out, stream, the events around the kernel)
    lib.mont_verify_launch.argtypes = [_P] * 5 + [_I, _P, _P, _P, _P]
    lib.mont_verify_launch.restype = ctypes.c_int
    lib.mont_kernel_attrs.argtypes = [ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.mont_kernel_attrs.restype = ctypes.c_int
    lib.ec_scalar_mult_launch.argtypes = _EC_LAUNCH_ARGS
    lib.ec_scalar_mult_launch.restype = ctypes.c_int
    lib.ec_kernel_attrs.argtypes = [ctypes.POINTER(_I)] * 4
    lib.ec_kernel_attrs.restype = ctypes.c_int
    lib.rns_error_string.argtypes = [ctypes.c_int]
    lib.rns_error_string.restype = ctypes.c_char_p
    return lib
