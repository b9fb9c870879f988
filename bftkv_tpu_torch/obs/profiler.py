"""Continuous wall-clock sampling profiler (collapsed-stack output;
counterpart of ``bftkv_tpu/obs/profiler.py``).

The profiler says which *code* owns a slow phase — without
instrumenting anything: a sampler thread walks
``sys._current_frames()`` at a fixed rate (default 67 Hz — prime, so
the sampling comb never phase-locks to millisecond-periodic work) and
folds every thread's stack into the collapsed flamegraph format
(``root;child;leaf count`` lines, the ``flamegraph.pl`` /
speedscope input).

Same arming contract as the failpoint plane: **off is free**.
``BFTKV_PROFILE`` unset means no thread, no wrapper, no per-call
anything — the profiler only exists as an idle module.  Armed, the
cost is one GIL-shared stack walk per tick (~tens of µs per thread),
bounded memory (``max_stacks`` unique stacks, deeper/rarer stacks fold
into an overflow bucket).

Surfaces: each daemon serves ``/profile?seconds=N`` (cmd/bftkv.py) —
an on-demand capture window over the continuous sampler (or a
temporary sampler when disarmed); the flight recorder snapshots
:func:`last` into every bundle.
"""

from __future__ import annotations

import sys
import threading
import time

from bftkv_tpu_torch import flags
from bftkv_tpu_torch.devtools.lockwatch import named_lock
from bftkv_tpu_torch.metrics import registry as metrics

__all__ = ["Profiler", "enabled", "ensure_started", "last", "profile_for"]

#: Leaf-frame function names that mean a thread is parked, not
#: competing for the GIL — the blocking primitives (lock/CV waits,
#: socket waits, queue gets, sleeps).  A leaf NOT in this set is
#: counted as runnable by the GIL-pressure estimate below; the set errs
#: toward "runnable" because a false runnable inflates the estimate
#: (visible, self-correcting) while a false blocked hides pressure.
_BLOCKED_LEAVES = frozenset({
    "wait", "acquire", "sleep", "select", "poll", "epoll", "accept",
    "recv", "recv_into", "read", "readinto", "readline", "get",
    "join", "settimeout", "connect", "getaddrinfo",
})


def enabled() -> bool:
    """The opt-in flag (read at call time, like every switch here)."""
    return flags.enabled("BFTKV_PROFILE")


class Profiler:
    """Bounded folding sampler over ``sys._current_frames()``.

    ``hz`` is the sampling rate; ``max_stacks`` bounds distinct
    collapsed stacks (overflow folds into ``<overflow>``); ``max_depth``
    bounds frames kept per stack (deeper stacks keep the LEAF side —
    the hot code — and fold the root side into ``<deep>``)."""

    def __init__(
        self,
        hz: float | None = None,
        max_stacks: int = 4096,
        max_depth: int = 48,
    ):
        self.hz = hz or float(flags.get_int("BFTKV_PROFILE_HZ") or 67)
        self.max_stacks = max_stacks
        self.max_depth = max_depth
        self._lock = named_lock("obs.profiler")
        self._counts: dict[str, int] = {}
        self._samples = 0
        self._overflow = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- sampling ----------------------------------------------------------

    def _fold(self, frame) -> str:
        parts: list[str] = []
        depth = 0
        while frame is not None and depth < self.max_depth:
            code = frame.f_code
            mod = code.co_filename.rsplit("/", 1)[-1]
            parts.append(f"{mod}:{code.co_name}")
            frame = frame.f_back
            depth += 1
        if frame is not None:
            parts.append("<deep>")
        parts.reverse()  # collapsed format runs root -> leaf
        return ";".join(parts)

    def sample_once(self) -> int:
        """One tick over every live thread except the sampler itself.
        Returns the number of stacks folded (tests drive this
        directly)."""
        me = threading.get_ident()
        n = 0
        # _current_frames() is one C-level snapshot under the GIL; the
        # frames may keep running while we walk them — a torn co_name
        # is impossible (strings are immutable), at worst a stack is
        # one frame stale, which sampling tolerates by definition.
        runnable = 0
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            if frame.f_code.co_name not in _BLOCKED_LEAVES:
                runnable += 1
            stack = self._fold(frame)
            with self._lock:
                if stack in self._counts:
                    self._counts[stack] += 1
                elif len(self._counts) < self.max_stacks:
                    self._counts[stack] = 1
                else:
                    self._overflow += 1
                self._samples += 1
            n += 1
        # GIL-pressure estimate: threads whose leaf frame is NOT a
        # blocking primitive are runnable — i.e. queued on the GIL.
        # Rides the sampler tick, so it costs nothing when the profiler
        # is disarmed (no sampler, no gauge) and the capacity plane's
        # gil resource simply reports absent.
        if flags.enabled("BFTKV_GIL_SAMPLER"):
            metrics.gauge(
                "gil.runnable", float(runnable),
                labels={"resource": "gil"},
            )
        return n

    def _run(self) -> None:
        period = 1.0 / self.hz
        while not self._stop.wait(period):
            try:
                self.sample_once()
            except Exception:
                pass  # the sampler must never take the process down

    def start(self) -> "Profiler":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="bftkv-profiler", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2)
            self._thread = None

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    # -- output ------------------------------------------------------------

    def collapsed(self) -> str:
        """The folded profile: one ``stack count`` line per unique
        stack, descending by count, plus the overflow bucket when the
        stack bound was hit."""
        with self._lock:
            items = sorted(
                self._counts.items(), key=lambda kv: -kv[1]
            )
            overflow = self._overflow
            samples = self._samples
        lines = [f"{stack} {count}" for stack, count in items]
        if overflow:
            lines.append(f"<overflow> {overflow}")
        header = (
            f"# bftkv profile: {samples} samples @ {self.hz:g} Hz "
            f"({len(items)} stacks)"
        )
        return "\n".join([header] + lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._samples = 0
            self._overflow = 0


# ---------------------------------------------------------------------------
# Process singletons: the continuous sampler (armed) + the last
# captured window (the flight recorder's "what was the box doing").
# ---------------------------------------------------------------------------

_global: Profiler | None = None
_global_lock = named_lock("obs.profiler.global")
_last: str = ""


def ensure_started() -> Profiler | None:
    """Start (once) and return the continuous process sampler when
    ``BFTKV_PROFILE`` is armed; None otherwise — the disarmed path is
    one flag read, no thread, no state."""
    global _global
    if not enabled():
        return None
    with _global_lock:
        if _global is None:
            _global = Profiler()
        return _global.start()


def profile_for(seconds: float) -> str:
    """One bounded capture window, collapsed-stack text.

    Armed: snapshots the continuous sampler's delta over the window
    (reset-free — concurrent windows each see the full interval
    superset, which sampling tolerates).  Disarmed: runs a TEMPORARY
    sampler for the window, so ``/profile?seconds=N`` works on demand
    without paying the always-on cost."""
    global _last
    seconds = min(max(seconds, 0.05), 30.0)
    p = ensure_started()
    if p is not None:
        before = dict(p._counts)
        time.sleep(seconds)
        with p._lock:
            after = dict(p._counts)
            samples = p._samples
        delta = {
            k: v - before.get(k, 0)
            for k, v in after.items()
            if v > before.get(k, 0)
        }
        lines = [
            f"{k} {v}"
            for k, v in sorted(delta.items(), key=lambda kv: -kv[1])
        ]
        header = (
            f"# bftkv profile: {seconds:g}s window @ {p.hz:g} Hz "
            f"(continuous sampler, {samples} total samples)"
        )
        out = "\n".join([header] + lines) + "\n"
    else:
        tmp = Profiler()
        tmp.start()
        try:
            time.sleep(seconds)
        finally:
            tmp.stop()
        out = tmp.collapsed()
    _last = out
    return out


def last() -> str:
    """The most recent captured window ('' when none) — what the
    flight recorder folds into a bundle."""
    return _last
