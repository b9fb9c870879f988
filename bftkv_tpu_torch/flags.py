"""The port's registry of the ``BFTKV_*`` environment flags it reads.

Same seam as ``bftkv_tpu/flags.py`` (:func:`raw`, :func:`get`,
:func:`enabled`): every read goes through here, and reading an
undeclared name raises ``KeyError``, so a flag cannot ship
undocumented.  The port keeps its own registry because the reference's
raises on names it does not declare and declares many the port does not
read yet; each later slice adds the names it starts to read.
"""

from __future__ import annotations

import os
from typing import NamedTuple

__all__ = ["Flag", "FLAGS", "declared", "enabled", "get", "get_int", "raw"]


class Flag(NamedTuple):
    name: str
    default: str | None  # None = unset (the call site's fallback applies)
    kind: str  # "switch" | "str" | "int" | "float"
    doc: str


FLAGS: dict[str, Flag] = {}


def _flag(name: str, default: str | None, kind: str, doc: str) -> None:
    if not name.startswith("BFTKV_") or name in FLAGS:
        raise ValueError(f"bad or duplicate flag declaration {name!r}")
    FLAGS[name] = Flag(name, default, kind, doc)


_flag("BFTKV_HOST_VERIFY_THRESHOLD", None, "int",
      "Batch size below which verifies stay on host (unset: "
      "VerifierDomain.HOST_CROSSOVER, or the dispatcher's calibration).")
_flag("BFTKV_HOST_SIGN_THRESHOLD", None, "int",
      "Batch size below which signs stay on host (unset: "
      "SignerDomain.HOST_CROSSOVER, or the dispatcher's calibration).")
_flag("BFTKV_DISPATCH_CROSSOVER", None, "int",
      "Operator override for the host/device verify crossover batch size "
      "(0 or negative pins always-host; unset: measured by calibration).")
_flag("BFTKV_VERIFY_BACKEND", "rns", "str",
      "RSA verify backend of VerifierDomain: `rns` (default, kernel K1), "
      "`limb` (the limb Montgomery engine in PyTorch ops), `pallas` (the "
      "limb chain as kernel K3; 2048-bit only).")
_flag("BFTKV_SIGN_BACKEND", "rns", "str",
      "RSA sign backend of SignerDomain: `rns` (default, kernel K2; groups "
      "the RNS bases decline go to the limb engine) or `limb`.")
_flag("BFTKV_TPU_MIN_MODEXP_BATCH", "4", "int",
      "BatchModExp batches below this size run as host pow.")
_flag("BFTKV_DISPATCH_CALIBRATE", "1", "switch",
      "Start-time host-vs-device crossover calibration of the dispatchers "
      "(`0` disables; a CPU device still pins always-host).")
_flag("BFTKV_DISPATCH_PIPELINE", None, "int",
      "Flushes in flight at once in a batching dispatcher (unset: 2 on a "
      "cuda device, 1 on the cpu).")
_flag("BFTKV_DISPATCH_ASYNC", "on", "switch",
      "Async dispatch: a flush whose dispatcher has a non-blocking launch "
      "(ModexpDispatcher) hands it to one completion-drain thread, which "
      "finalizes launches FIFO; `off` restores fully synchronous flushes.")
_flag("BFTKV_DISPATCH_DEVBUF", "on", "switch",
      "Persistent staging rings (ops/devbuf.py): launches write their "
      "operands into preallocated pinned host and device tensors; `off` "
      "allocates per launch.")
_flag("BFTKV_DISPATCH_DEVBUF_RING", "4", "int",
      "Slots per staging ring; with every slot in flight the next launch "
      "allocates a fresh one (devbuf.overflow) instead of blocking.")
_flag("BFTKV_TRACE", "on", "switch",
      "Trace-id/span plane (trace.py); `off` disables tracing entirely.")
_flag("BFTKV_SLOW_TRACE_SECONDS", "1.0", "float",
      "Slow-trace threshold: root spans above it land in the slow ring and "
      "the one-JSON-line slow log.")
_flag("BFTKV_LOCKWATCH", "", "switch",
      "Opt-in runtime lock sanitizer (devtools/lockwatch.py): lock-order "
      "cycles and blocking calls under watched locks.")


def _check(name: str) -> Flag:
    f = FLAGS.get(name)
    if f is None:
        raise KeyError(
            f"undeclared BFTKV flag {name!r}: declare it in "
            "bftkv_tpu_torch/flags.py before reading it"
        )
    return f


def declared() -> dict[str, Flag]:
    """Name → :class:`Flag` for every declared flag."""
    return dict(FLAGS)


def raw(name: str, default: str | None = None) -> str | None:
    """The raw environment value, or ``default`` when unset."""
    _check(name)
    v = os.environ.get(name)
    return default if v is None else v


def get(name: str) -> str | None:
    """Environment value, falling back to the registry default."""
    f = _check(name)
    v = os.environ.get(name)
    return f.default if v is None else v


def get_int(name: str, default: int | None = None) -> int | None:
    """Integer value; unset or empty falls back to ``default``, then to
    the registry default."""
    f = _check(name)
    v = os.environ.get(name)
    if v is None or v == "":
        if default is not None:
            return default
        return int(f.default) if f.default is not None else None
    return int(v)


def enabled(name: str, default: str | None = None) -> bool:
    """Switch semantics of the reference: a set value is on unless it
    lowercases to ``off``/``0``/``false``; unset falls back to
    ``default``, then to the registry default (empty means off)."""
    f = _check(name)
    v = os.environ.get(name)
    if v is None:
        v = default if default is not None else (f.default or "")
        if v == "":
            return False
    return v.lower() not in ("off", "0", "false")
