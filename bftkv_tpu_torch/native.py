"""Builds and loads the two host C extensions the port shares with the
reference: ``native/packetcodec.c`` (the packet codec) and
``native/montmodexp.c`` (the Montgomery modexp behind host RSA signing).

The reference runs ``make`` inside ``native/`` and loads the ``.so`` it
leaves there.  The port never writes to ``native/``: it compiles the
same sources, with the same flags as ``native/Makefile``, into its own
``bftkv_tpu_torch/_build/native/`` (listed in ``.gitignore``).  Headers
and the ABI tag come from the running interpreter.  The check, the build
and the load run under a file lock in that directory, so processes that
start together build once, and the compiler writes a temporary file that
is renamed into place: no process ever loads a torn library.

:func:`load` returns the module, or ``None`` where the build or the load
fails (no C compiler, no ``Python.h``); callers keep their pure-Python
versions for that case.
"""

from __future__ import annotations

import fcntl
import importlib.util
import os
import subprocess
import sysconfig

__all__ = ["BUILD_DIR", "SOURCE_DIR", "load"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE_DIR = os.path.join(os.path.dirname(_HERE), "native")
BUILD_DIR = os.path.join(_HERE, "_build", "native")

# Per extension: its source and the flags native/Makefile gives it.
_FLAGS = {
    "_packetcodec": ("packetcodec.c", ["-O2", "-fPIC", "-Wall"]),
    "_montmodexp": ("montmodexp.c", ["-O2", "-fPIC", "-Wall", "-O3"]),
}


def _build(name: str) -> str:
    src_name, cflags = _FLAGS[name]
    src = os.path.join(SOURCE_DIR, src_name)
    so_path = os.path.join(BUILD_DIR, name + sysconfig.get_config_var("EXT_SUFFIX"))
    if os.path.exists(so_path) and os.path.getmtime(so_path) >= os.path.getmtime(src):
        return so_path
    tmp = f"{so_path}.{os.getpid()}.tmp"
    inc = sysconfig.get_paths()["include"]
    cc = os.environ.get("CC") or "cc"
    try:
        subprocess.run(
            [cc, *cflags, f"-I{inc}", "-shared", "-o", tmp, src],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so_path


def load(name: str):
    """The extension ``name`` (``_packetcodec`` or ``_montmodexp``) built
    from this checkout's ``native/`` sources, or ``None``."""
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, f".{name}.lock"), "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            so_path = _build(name)
            spec = importlib.util.spec_from_file_location(f"bftkv_tpu_torch.{name}", so_path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        return mod
    except Exception:
        return None
