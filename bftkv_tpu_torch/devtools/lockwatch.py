"""A copy of ``bftkv_tpu/devtools/lockwatch.py`` (imports rewritten to the
port's ``flags``); the port's locks are created through
:func:`named_lock`.

Opt-in runtime lock sanitizer (``BFTKV_LOCKWATCH=1``).

The project's locking rules were enforced by prose until this module:
DESIGN.md said "I/O moved outside the store lock" and "the
``_DaemonPool`` nested-overflow deadlock" in words, and nothing
machine-checked either.  Lockwatch turns both into runtime checks:

- **Lock-order graph.**  Every lock created through :func:`named_lock`
  is a node named by its *class* (``storage.plain``, ``metrics``,
  ``transport.pool`` — one node per name, lockdep-style, so an
  ordering violation between any two instances of two classes is
  caught even when the two runs never touch the same instances).
  Acquiring B while holding A records the edge A→B with the first
  acquire site; a cycle in the directed graph is a potential deadlock
  (:func:`report` lists each cycle once).
- **Blocking calls under a watched lock.**  Arming patches a small set
  of blocking choke points (``builtins.open``, ``os.listdir``,
  ``os.fsync``, ``socket.create_connection``,
  ``http.client.HTTPConnection.request``/``getresponse``,
  ``time.sleep``); a patched call executed while the thread holds a
  lock whose name matches :data:`WATCHED_PREFIXES` (storage / metrics
  / route-table / quorum classes) is the "I/O under the store
  lock" bug class and is recorded as a finding.

**Zero overhead disarmed** is a hard contract, like the failpoint
plane's: :func:`named_lock` returns a *plain* ``threading.Lock`` /
``RLock`` when the flag is off — no wrapper, no indirection, nothing
patched — so the steady-state hot path is bit-for-bit the pre-lockwatch
build (tests/test_lockwatch.py holds a perf-parity smoke over it).

Known-benign findings are waived in code, where the next reader needs
them: either a ``with lockwatch.waiver("reason"):`` region (suppresses
recording on this thread — e.g. PlainStorage's one-time index rebuild,
which must hold the lock across its first ``listdir``) or a declared
:func:`waive_order` pair for a benign A→B/B→A report.  Waivers carry
their reason into :func:`report` so the soak log shows WHAT was waived.

Wired into tier-1 via a conftest gate and into the nightly
``nemesis`` soak (exit non-zero on any cycle or under-lock blocking
call); see DESIGN.md §16.
"""

from __future__ import annotations

import threading
from typing import Any

from bftkv_tpu_torch import flags

__all__ = [
    "ARMED",
    "WATCHED_PREFIXES",
    "arm",
    "disarm",
    "enabled",
    "named_lock",
    "report",
    "reset",
    "waive_order",
    "waiver",
]

#: Lock-name prefixes whose holders must never block (the invariant
#: classes: storage stores, the metrics registry, the
#: route table / quorum caches, the trust-graph generation guard).
WATCHED_PREFIXES = ("storage.", "metrics", "quorum.", "graph.")

#: Module-level arm flag, failpoint-style: cheap to read, and
#: :func:`named_lock` consults it once per lock CONSTRUCTION (not per
#: acquire), so disarmed cost is literally zero.
ARMED = False

_state_lock = threading.Lock()
#: (holder_name, acquired_name) -> first-seen acquire site "file:line".
_edges: dict[tuple[str, str], str] = {}
#: Waived directed orders with reasons.
_waived_orders: dict[tuple[str, str], str] = {}
#: Blocking-call findings: (lock_name, func, site) -> count.
_blocking: dict[tuple[str, str, str], int] = {}
_tls = threading.local()

_patched: list[tuple[Any, str, Any]] = []


def enabled() -> bool:
    return ARMED


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _waiver_depth() -> int:
    return getattr(_tls, "waive", 0)


class waiver:
    """Suppress lockwatch recording on this thread inside the block.

    Use for a known-benign region, with the reason in the source:
    ``with lockwatch.waiver("first-use index rebuild holds the lock"):``
    """

    def __init__(self, reason: str):
        self.reason = reason

    def __enter__(self):
        _tls.waive = _waiver_depth() + 1
        return self

    def __exit__(self, *exc):
        _tls.waive = _waiver_depth() - 1
        return False


def _acquire_site() -> str:
    import sys

    # Caller of the lock proxy: skip lockwatch frames.
    f = sys._getframe(2)
    while f is not None and "lockwatch" in f.f_code.co_filename:
        f = f.f_back
    if f is None:  # pragma: no cover
        return "?"
    return f"{f.f_code.co_filename}:{f.f_lineno}"


def _note_acquired(name: str) -> None:
    held = _held()
    if _waiver_depth() == 0:
        for h in held:
            if h == name:
                continue  # reentrant same-class hold: not an order edge
            edge = (h, name)
            if edge not in _edges:
                site = _acquire_site()
                with _state_lock:
                    _edges.setdefault(edge, site)
    held.append(name)


def _note_released(name: str) -> None:
    held = _held()
    # Out-of-order release is legal; drop the most recent hold of name.
    for i in range(len(held) - 1, -1, -1):
        if held[i] == name:
            del held[i]
            return


class _WatchedLock:
    """Proxy recording acquisition order; duck-compatible with
    ``threading.Lock``/``RLock`` (incl. ``threading.Condition(lock)``,
    which only needs acquire/release and falls back to its own
    ``_is_owned`` emulation for foreign lock objects)."""

    __slots__ = ("_lock", "name")

    def __init__(self, name: str, *, rlock: bool = False):
        self._lock = threading.RLock() if rlock else threading.Lock()
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _note_acquired(self.name)
        return ok

    def release(self) -> None:
        self._lock.release()
        _note_released(self.name)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover
        return f"<lockwatch {self.name} {self._lock!r}>"


def named_lock(name: str, *, rlock: bool = False):
    """The project-wide lock seam: every ``threading.Lock()`` in
    ``bftkv_tpu_torch/`` is created through here with a stable class name.
    Disarmed (the default) this returns the plain stdlib lock object —
    zero wrapper, zero overhead."""
    if not ARMED:
        return threading.RLock() if rlock else threading.Lock()
    return _WatchedLock(name, rlock=rlock)


# ---------------------------------------------------------------------------
# Blocking-call choke points (patched only while armed).
# ---------------------------------------------------------------------------


def _watched_holds() -> list:
    held = getattr(_tls, "held", None)
    if not held:
        return []
    return [
        h for h in held if any(h.startswith(p) for p in WATCHED_PREFIXES)
    ]


def _note_blocking(func: str) -> None:
    if _waiver_depth():
        return
    for h in _watched_holds():
        site = _acquire_site()
        key = (h, func, site)
        with _state_lock:
            _blocking[key] = _blocking.get(key, 0) + 1


def _wrap_callable(owner: Any, attr: str, label: str) -> None:
    orig = getattr(owner, attr)

    def wrapper(*a, **kw):
        _note_blocking(label)
        return orig(*a, **kw)

    wrapper.__name__ = getattr(orig, "__name__", attr)
    wrapper.__lockwatch_orig__ = orig
    setattr(owner, attr, wrapper)
    _patched.append((owner, attr, orig))


def _patch_blocking() -> None:
    import builtins
    import http.client
    import os
    import socket
    import time

    _wrap_callable(builtins, "open", "open")
    _wrap_callable(os, "listdir", "os.listdir")
    _wrap_callable(os, "fsync", "os.fsync")
    _wrap_callable(socket, "create_connection", "socket.connect")
    _wrap_callable(http.client.HTTPConnection, "request", "http.request")
    _wrap_callable(
        http.client.HTTPConnection, "getresponse", "http.response"
    )
    _wrap_callable(time, "sleep", "time.sleep")


def _unpatch_blocking() -> None:
    while _patched:
        owner, attr, orig = _patched.pop()
        setattr(owner, attr, orig)


# ---------------------------------------------------------------------------
# Lifecycle + reporting.
# ---------------------------------------------------------------------------


def arm() -> None:
    """Arm the sanitizer: locks created from now on through
    :func:`named_lock` are watched, and the blocking choke points are
    patched.  Locks created before arming stay plain (arm at process
    start — the ``BFTKV_LOCKWATCH=1`` path — to watch everything)."""
    global ARMED
    if ARMED:
        return
    reset()
    _patch_blocking()
    ARMED = True


def disarm() -> None:
    global ARMED
    ARMED = False
    _unpatch_blocking()


def reset() -> None:
    """Clear recorded edges/findings (waived orders persist — they are
    code-declared facts, not run state)."""
    with _state_lock:
        _edges.clear()
        _blocking.clear()


def waive_order(first: str, then: str, reason: str) -> None:
    """Declare the directed order ``first`` held while acquiring
    ``then`` as known-benign; edges matching it are excluded from
    cycle analysis and listed under ``waived`` in :func:`report`."""
    with _state_lock:
        _waived_orders[(first, then)] = reason


def _find_cycles(adj: dict[str, set]) -> list[list[str]]:
    """Each elementary cycle once (rooted at its smallest node)."""
    cycles: list[list[str]] = []
    seen: set = set()
    nodes = sorted(adj)
    for root in nodes:
        stack = [(root, [root])]
        while stack:
            node, path = stack.pop()
            for nxt in sorted(adj.get(node, ())):
                if nxt == root and len(path) > 1:
                    key = frozenset(path)
                    if key not in seen:
                        seen.add(key)
                        cycles.append(path + [root])
                elif nxt not in path and nxt > root:
                    stack.append((nxt, path + [nxt]))
        # Self-loops cannot occur: reentrant holds are filtered at
        # record time.
    return cycles


def report() -> dict:
    """Machine-readable findings:

    ``{"cycles": [[a, b, a], ...], "blocking": [{lock, func, site,
    count}], "edges": {...}, "waived": [...]}`` — the pytest gate and
    the nemesis soak fail on non-empty ``cycles`` or ``blocking``."""
    with _state_lock:
        edges = dict(_edges)
        blocking = dict(_blocking)
        waived = dict(_waived_orders)
    adj: dict[str, set] = {}
    waived_hits = []
    for (a, b), site in edges.items():
        if (a, b) in waived:
            waived_hits.append(
                {"order": [a, b], "site": site, "reason": waived[(a, b)]}
            )
            continue
        adj.setdefault(a, set()).add(b)
    return {
        "cycles": _find_cycles(adj),
        "blocking": [
            {"lock": lk, "func": fn, "site": site, "count": n}
            for (lk, fn, site), n in sorted(blocking.items())
        ],
        "edges": {f"{a}->{b}": site for (a, b), site in sorted(edges.items())},
        "waived": waived_hits,
    }


def fail_message() -> str | None:
    """None when clean; else a human-readable findings summary (the
    string the conftest gate asserts on and nemesis prints)."""
    rep = report()
    if not rep["cycles"] and not rep["blocking"]:
        return None
    lines = ["lockwatch findings:"]
    for cyc in rep["cycles"]:
        lines.append("  lock-order cycle: " + " -> ".join(cyc))
    for b in rep["blocking"]:
        lines.append(
            f"  blocking call under lock: {b['func']} while holding "
            f"{b['lock']} at {b['site']} (x{b['count']})"
        )
    return "\n".join(lines)


# Arm at import when the flag is set: lock construction happens at
# module import / object init all over the package, so the decision
# must be made before anything else imports.
if flags.enabled("BFTKV_LOCKWATCH"):  # pragma: no cover - env-dependent
    arm()
