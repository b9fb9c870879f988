"""Builds and loads the host native code the port shares with the
reference: two C extensions, ``native/packetcodec.c`` (the packet codec)
and ``native/montmodexp.c`` (the Montgomery modexp behind host RSA
signing), and one plain C++ shared library, ``native/kvstore.cpp`` (the
engine behind ``storage/native.py``, bound through ctypes).

The reference runs ``make`` inside ``native/`` and loads the ``.so`` it
leaves there.  The port never writes to ``native/``: it compiles the
same sources, with the same flags as ``native/Makefile``, into its own
``bftkv_tpu_torch/_build/native/`` (listed in ``.gitignore``).  Headers
and the ABI tag come from the running interpreter.  The check, the build
and the load run under a file lock in that directory, so processes that
start together build once, and the compiler writes a temporary file that
is renamed into place: no process ever loads a torn library.

:func:`load` returns an extension module, or ``None`` where the build or
the load fails (no C compiler, no ``Python.h``); callers keep their
pure-Python versions for that case.  :func:`shared_library` returns the
path of a built shared library and raises where the build fails: its
caller has no other engine to fall back to.
"""

from __future__ import annotations

import contextlib
import fcntl
import importlib.util
import os
import subprocess
import sysconfig

__all__ = ["BUILD_DIR", "SOURCE_DIR", "load", "shared_library"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE_DIR = os.path.join(os.path.dirname(_HERE), "native")
BUILD_DIR = os.path.join(_HERE, "_build", "native")

# Per extension: its source and the flags native/Makefile gives it.
_FLAGS = {
    "_packetcodec": ("packetcodec.c", ["-O2", "-fPIC", "-Wall"]),
    "_montmodexp": ("montmodexp.c", ["-O2", "-fPIC", "-Wall", "-O3"]),
}
# Per shared library: its source and native/Makefile's CXXFLAGS.
_SHARED = {
    "libbftkvstore": ("kvstore.cpp", ["-O2", "-fPIC", "-std=c++17", "-Wall"]),
}


def _build(src_name: str, so_path: str, cmd: list[str]) -> str:
    src = os.path.join(SOURCE_DIR, src_name)
    if os.path.exists(so_path) and os.path.getmtime(so_path) >= os.path.getmtime(src):
        return so_path
    tmp = f"{so_path}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            [*cmd, "-shared", "-o", tmp, src],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so_path


@contextlib.contextmanager
def _locked(name: str):
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f".{name}.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        yield


def load(name: str):
    """The extension ``name`` (``_packetcodec`` or ``_montmodexp``) built
    from this checkout's ``native/`` sources, or ``None``."""
    src_name, cflags = _FLAGS[name]
    so_path = os.path.join(BUILD_DIR, name + sysconfig.get_config_var("EXT_SUFFIX"))
    inc = sysconfig.get_paths()["include"]
    cc = os.environ.get("CC") or "cc"
    try:
        with _locked(name):
            _build(src_name, so_path, [cc, *cflags, f"-I{inc}"])
            spec = importlib.util.spec_from_file_location(f"bftkv_tpu_torch.{name}", so_path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        return mod
    except Exception:
        return None


def shared_library(name: str) -> str:
    """The path of the shared library ``name`` (``libbftkvstore``) built
    from this checkout's ``native/`` sources.  A failed build raises
    (``subprocess.CalledProcessError`` or ``OSError``), as the
    reference's ``make`` with ``check=True`` does."""
    src_name, cxxflags = _SHARED[name]
    cxx = os.environ.get("CXX") or "c++"
    with _locked(name):
        return _build(src_name, os.path.join(BUILD_DIR, name + ".so"), [cxx, *cxxflags])
