"""ctypes binding for the C++ log-structured KV engine (counterpart of ``bftkv_tpu/storage/native.py``).

The native analog of the reference's leveldb backend
(reference: storage/leveldb/leveldb.go:22-53). The shared library is
built on demand from ``native/kvstore.cpp`` (no pybind11 in the image;
plain C ABI + ctypes).  The reference runs ``make`` inside ``native/``;
the port compiles the same source with the Makefile's ``CXXFLAGS`` into
``bftkv_tpu_torch/_build/native/libbftkvstore.so``
(:func:`bftkv_tpu_torch.native.shared_library`) and never writes to
``native/``.  A failed build raises: there is no fallback engine.
"""

from __future__ import annotations

import ctypes
import os

from bftkv_tpu_torch import native
from bftkv_tpu_torch.errors import ERR_NOT_FOUND, new_error
from bftkv_tpu_torch.devtools.lockwatch import named_lock

ERR_STORAGE_IO = new_error("storage I/O failure")

_lib = None
_lib_lock = named_lock("storage.native.lib")


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        # The build checks the source's mtime against the library's, so
        # an up-to-date build is a no-op and a stale one is rebuilt
        # before the symbols below are bound.
        lib = ctypes.CDLL(native.shared_library("libbftkvstore"))
        lib.kv_open.restype = ctypes.c_void_p
        lib.kv_open.argtypes = [ctypes.c_char_p]
        lib.kv_close.argtypes = [ctypes.c_void_p]
        lib.kv_write.restype = ctypes.c_int
        lib.kv_write.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_uint32,
            ctypes.c_uint64,
            ctypes.c_char_p,
            ctypes.c_uint64,
        ]
        lib.kv_read.restype = ctypes.c_int64
        lib.kv_read.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_uint32,
            ctypes.c_uint64,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.kv_versions.restype = ctypes.c_int64
        lib.kv_versions.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64,
        ]
        lib.kv_keys.restype = ctypes.c_int64
        lib.kv_keys.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_uint64,
        ]
        _lib = lib
        return lib


class NativeStorage:
    def __init__(self, path: str):
        self._lib = _load()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        handle = self._lib.kv_open(path.encode())
        if not handle:
            raise ERR_STORAGE_IO
        self._handle = handle
        self._lock = named_lock("storage.native")

    def close(self) -> None:
        with self._lock:
            if self._handle:
                self._lib.kv_close(self._handle)
                self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass

    def read(self, variable: bytes, t: int = 0) -> bytes:
        with self._lock:
            # Protocol threads (read-repair, late sign persists) can
            # outlive a close(); a NULL handle into the C ABI would be a
            # use-after-free — fail as storage I/O instead.
            if not self._handle:
                raise ERR_STORAGE_IO
            t_out = ctypes.c_uint64(0)
            n = self._lib.kv_read(
                self._handle, variable, len(variable), t, None, ctypes.byref(t_out)
            )
            if n == -1:
                raise ERR_NOT_FOUND
            if n < 0:
                raise ERR_STORAGE_IO
            buf = ctypes.create_string_buffer(int(n))
            # Re-read pinned at the resolved timestamp so a concurrent
            # write of a newer version between the two calls is harmless.
            n2 = self._lib.kv_read(
                self._handle, variable, len(variable), t_out.value, buf, None
            )
            if n2 < 0 or n2 != n:
                raise ERR_STORAGE_IO
            return buf.raw[: int(n)]

    def versions(self, variable: bytes) -> list[int]:
        """All stored version timestamps, descending (storage contract —
        the server read path's scan past in-progress sign records)."""
        with self._lock:
            if not self._handle:
                return []
            cap = 64
            while True:
                buf = (ctypes.c_uint64 * cap)()
                n = self._lib.kv_versions(
                    self._handle, variable, len(variable), buf, cap
                )
                if n < 0:
                    return []
                if n <= cap:
                    return list(buf[: int(n)])
                cap = int(n)

    def keys(self) -> list[bytes]:
        """Every stored variable (storage contract — anti-entropy):
        length-prefixed names out of the C index, two-call sizing like
        :meth:`versions`."""
        with self._lock:
            if not self._handle:
                return []
            cap = 0
            buf = None
            while True:
                n = self._lib.kv_keys(self._handle, buf, cap)
                if n < 0:
                    return []
                if n <= cap:
                    break
                # A concurrent write may grow the index between the
                # sizing and filling calls; loop until it fits.
                cap = int(n)
                buf = ctypes.create_string_buffer(cap)
            out: list[bytes] = []
            data = buf.raw[: int(n)] if buf is not None else b""
            off = 0
            while off + 4 <= len(data):
                ln = int.from_bytes(data[off : off + 4], "little")
                off += 4
                out.append(data[off : off + ln])
                off += ln
            return out

    def scan(self) -> list[tuple[bytes, int]]:
        """Every stored ``(variable, t)`` pair."""
        return [(var, t) for var in self.keys() for t in self.versions(var)]

    def write(self, variable: bytes, t: int, value: bytes) -> None:
        with self._lock:
            if not self._handle:
                raise ERR_STORAGE_IO
            rc = self._lib.kv_write(
                self._handle, variable, len(variable), t, value, len(value)
            )
            if rc != 0:
                raise ERR_STORAGE_IO
