"""The interpreter collector's policy for a process that serves requests.

A serving process holds two kinds of tracked objects: the long-lived
state it builds before it serves (modules, torch, the universe, keys,
servers, clients, RNS contexts, the store) and the short-lived state of
each request (a ``write_many``'s records across its sign and write
phases, a dispatcher flush's items).  At the interpreter's young
thresholds the request state outlives two young collections and is
promoted, and every generation-2 pass that the promotions trigger scans
the whole heap while every thread of the process waits.

:func:`apply` raises the young thresholds to :data:`YOUNG_THRESHOLDS`,
so that request state dies young; :func:`release` restores the
thresholds that were set before.  The policy holds while any owner holds
it: the dispatch plane (``ops/dispatch.py``, from its first installed
dispatcher to its last), each verify sidecar service
(``cmd/verify_sidecar.py``, from its start to its stop) and the
``bftkv`` daemon once it has built its server.  Automatic collection
stays on and no request path collects.
"""

from __future__ import annotations

import gc

from bftkv_tpu_torch.devtools.lockwatch import named_lock

__all__ = ["YOUNG_THRESHOLDS", "apply", "release"]

#: Generation 0 collected every 50,000 net allocations of tracked objects,
#: generation 1 every 20 of those passes; generation 2's threshold stays
#: the interpreter's.  Chosen from the serving process's own numbers
#: (PERF.md §6): a write's state lives 0.4–0.75 s, and at the
#: interpreter's (700, 10) a generation-1 pass came every ~0.1 s, promoted
#: that state, and so set off 40 generation-2 passes in 51 s, up to 0.6 s
#: each with every thread stopped.  At (50,000, 20) the same process ran
#: 24 generation-0 passes (at most 36 ms), one generation-1 pass and no
#: generation-2 pass in 51 s; at (20,000, 20) the young passes took twice
#: the time, and at (5,000, 20) four times and two full passes came back.
YOUNG_THRESHOLDS = (50_000, 20)

_lock = named_lock("gcpolicy")
#: Who holds the policy now.
_owners: set = set()
#: While held: the thresholds before.
_saved: tuple[int, ...] | None = None


def apply(owner) -> bool:
    """``owner`` holds the policy (a second hold by the same owner is a
    no-op); whether this call set the thresholds."""
    global _saved
    with _lock:
        first = not _owners
        _owners.add(owner)
        if first:
            _saved = gc.get_threshold()
            gc.set_threshold(*YOUNG_THRESHOLDS)
        return first


def release(owner) -> None:
    """``owner`` lets go; the last owner to go restores the thresholds."""
    global _saved
    with _lock:
        if owner not in _owners:
            return
        _owners.discard(owner)
        if not _owners:
            gc.set_threshold(*_saved)
            _saved = None
