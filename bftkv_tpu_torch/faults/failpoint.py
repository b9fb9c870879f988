"""A copy of ``bftkv_tpu/faults/failpoint.py`` (imports rewritten to the
port's ``metrics`` and ``devtools.lockwatch``); in the port only the
dispatch plane's ``dispatch.flush`` hook is woven in so far.

Seeded, deterministic failpoint registry.

A **failpoint** is a named hook woven into a production code path
(``transport.send``, ``server.admission``, ``storage.write``,
``server.time``, ``dispatch.flush``, ``sync.round``).  The hook calls
:func:`fire` with a small context dict; armed rules matching that
context return an :class:`Action` the hook site interprets (drop the
post, sleep, corrupt the payload, raise an error, run a Byzantine
handler instead, ...).

Two properties the whole chaos harness leans on:

- **Zero overhead disarmed.**  Hook sites guard with ``if fp.ARMED:``
  — one module-attribute load and branch — before building the context
  dict, and :func:`fire` itself re-checks.  ``bench.py cluster_4`` with
  failpoints disarmed must be within noise of a build without them.
- **Determinism from one seed.**  Every probabilistic decision (fire /
  skip, delay length, corrupt offset) is ``sha256(seed | rule_id | n)``
  where ``n`` is that rule's evaluation counter — *not* a shared RNG
  stream.  A deterministic call sequence therefore yields a
  byte-identical fault trace for the same seed, and concurrent rules
  cannot perturb each other's draws (within one rule, concurrent calls
  take counter values in arrival order: the decision *set* is fixed,
  only its assignment to threads may vary).

The registry records every fired event into a bounded trace
(:meth:`FaultRegistry.trace`) and counts them as ``faults.fired``
metrics labeled by (point, action) — both closed enums.
"""

from __future__ import annotations

import hashlib
from collections import deque
from typing import NamedTuple

from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.devtools.lockwatch import named_lock

__all__ = [
    "ARMED",
    "Action",
    "FaultEvent",
    "FaultRegistry",
    "Rule",
    "arm",
    "disarm",
    "fire",
    "registry",
    "corrupt_bytes",
    "delay_seconds",
    "link_of",
]

#: Global arm flag.  Hook sites read ``failpoint.ARMED`` (module
#: attribute, not a from-import — the value must be current) before
#: paying for context construction.
ARMED = False


class Action:
    """What a fired rule tells the hook site to do."""

    __slots__ = ("kind", "params", "rule")

    def __init__(self, kind: str, params: dict, rule: "Rule"):
        self.kind = kind
        self.params = params
        self.rule = rule

    def __repr__(self) -> str:  # pragma: no cover
        return f"Action({self.kind!r}, {self.params!r})"


class FaultEvent(NamedTuple):
    """One fired failpoint — the unit of the reproducible fault trace.
    ``eval_n`` is the rule's evaluation counter at fire time, so two
    runs with the same seed and call sequence produce identical lists."""

    seq: int
    point: str
    rule_id: str
    eval_n: int
    kind: str


class Rule:
    """One armed behavior at one failpoint.

    ``match``: ``None`` (always), a dict of context-key → expected
    value (or predicate over the value), or a predicate over the whole
    context dict.  ``prob``: fire probability per matching evaluation,
    decided by the seed-hash draw.  ``times``: max fires (``None`` =
    unlimited).  ``quiet`` rules fire without tracing or counting —
    the WAN topology plane uses them: a link delay that *is* the
    deployment geography is an environment, not a fault, and must not
    flood the trace or the ``fault_injected`` anomaly feed.  A
    ``background`` rule is evaluated only after every foreground rule
    at its point declined — so an always-matching topology delay can
    never shadow a nemesis step's drop rule added later at the same
    hook.  Remaining kwargs land in ``Action.params``.
    """

    __slots__ = (
        "point",
        "rule_id",
        "kind",
        "params",
        "match",
        "prob",
        "times",
        "enabled",
        "quiet",
        "background",
        "_evals",
        "_fires",
    )

    def __init__(
        self,
        point: str,
        kind: str,
        *,
        rule_id: str,
        match=None,
        prob: float = 1.0,
        times: int | None = None,
        quiet: bool = False,
        background: bool = False,
        **params,
    ):
        self.point = point
        self.rule_id = rule_id
        self.kind = kind
        self.params = params
        self.match = match
        self.prob = prob
        self.times = times
        self.enabled = True
        self.quiet = quiet
        self.background = background
        self._evals = 0
        self._fires = 0

    @property
    def fires(self) -> int:
        return self._fires

    def _matches(self, ctx: dict) -> bool:
        m = self.match
        if m is None:
            return True
        if callable(m):
            return bool(m(ctx))
        for k, want in m.items():
            have = ctx.get(k)
            if callable(want):
                if not want(have):
                    return False
            elif have != want:
                return False
        return True


def _draws(seed: int, rule_id: str, n: int) -> tuple[float, float]:
    """Two uniforms in [0, 1): the fire decision and the parameter
    draw, both pure functions of (seed, rule, evaluation index)."""
    h = hashlib.sha256(f"{seed}|{rule_id}|{n}".encode()).digest()
    return (
        int.from_bytes(h[:8], "big") / 2**64,
        int.from_bytes(h[8:16], "big") / 2**64,
    )


class FaultRegistry:
    """Process-wide rule set + reproducible fault trace."""

    TRACE_MAX = 65536

    def __init__(self):
        self._lock = named_lock("faults.registry")
        self._rules: dict[str, list[Rule]] = {}
        self._seed = 0
        self._seq = 0
        self._events: deque[FaultEvent] = deque(maxlen=self.TRACE_MAX)

    # -- lifecycle --------------------------------------------------------

    @property
    def seed(self) -> int:
        return self._seed

    def arm(self, seed: int = 0) -> "FaultRegistry":
        """Arm the hooks; all decisions derive from ``seed``.  Clears
        any previous rules and trace so a run starts from a clean
        deterministic state.  The armed registry becomes the ACTIVE
        one :func:`fire` dispatches to (last arm wins) — so a harness
        may run its own ``FaultRegistry`` instance and the hook sites
        still see its rules."""
        global ARMED, _active
        with self._lock:
            self._rules.clear()
            self._events.clear()
            self._seq = 0
            self._seed = seed
        _active = self
        ARMED = True
        return self

    def disarm(self) -> None:
        """Back to the zero-overhead no-op state."""
        global ARMED, _active
        ARMED = False
        _active = registry
        with self._lock:
            self._rules.clear()
            self._events.clear()
            self._seq = 0

    # -- rules ------------------------------------------------------------

    def add(
        self,
        point: str,
        kind: str,
        *,
        match=None,
        prob: float = 1.0,
        times: int | None = None,
        rule_id: str | None = None,
        quiet: bool = False,
        background: bool = False,
        **params,
    ) -> Rule:
        with self._lock:
            if rule_id is None:
                rule_id = f"{point}#{sum(len(r) for r in self._rules.values())}"
            rule = Rule(
                point,
                kind,
                rule_id=rule_id,
                match=match,
                prob=prob,
                times=times,
                quiet=quiet,
                background=background,
                **params,
            )
            rules = self._rules.setdefault(point, [])
            if background:
                rules.append(rule)
            else:
                # Foreground rules stay ahead of every background rule
                # regardless of arrival order: _fire returns the FIRST
                # match, and a topology delay must never shadow a fault
                # rule armed later at the same point.
                i = next(
                    (j for j, r in enumerate(rules) if r.background),
                    len(rules),
                )
                rules.insert(i, rule)
            return rule

    def remove(self, rule: Rule) -> None:
        with self._lock:
            rules = self._rules.get(rule.point)
            if rules and rule in rules:
                rules.remove(rule)

    def remove_all(self, rules) -> None:
        for r in rules:
            self.remove(r)

    def clear_rules(self) -> None:
        with self._lock:
            self._rules.clear()

    # -- firing -----------------------------------------------------------

    def _fire(self, point: str, ctx: dict) -> Action | None:
        with self._lock:
            rules = self._rules.get(point)
            if not rules:
                return None
            for rule in rules:
                if not rule.enabled:
                    continue
                if rule.times is not None and rule._fires >= rule.times:
                    continue
                if not rule._matches(ctx):
                    continue
                n = rule._evals
                rule._evals += 1
                p, u = _draws(self._seed, rule.rule_id, n)
                if rule.prob < 1.0 and p >= rule.prob:
                    continue
                rule._fires += 1
                if not rule.quiet:
                    self._seq += 1
                    self._events.append(
                        FaultEvent(
                            self._seq, point, rule.rule_id, n, rule.kind
                        )
                    )
                    metrics.incr(
                        "faults.fired",
                        labels={"point": point, "action": rule.kind},
                    )
                params = dict(rule.params)
                params["u"] = u
                return Action(rule.kind, params, rule)
        return None

    def trace(self) -> list[FaultEvent]:
        with self._lock:
            return list(self._events)

    def would_drop(self, point: str, **ctx) -> bool:
        """Side-effect-free: would an armed ``drop`` rule match this
        context right now?  Health probes use it — a probe must
        OBSERVE a partition (an in-process cut never unregisters the
        transport) without consuming rule fire budgets, perturbing
        the seeded parameter draws, or echoing into the fault trace
        the way a real :meth:`_fire` evaluation would."""
        with self._lock:
            for rule in self._rules.get(point, ()):
                if (
                    rule.enabled
                    and rule.kind == "drop"
                    and (rule.times is None or rule._fires < rule.times)
                    and rule._matches(ctx)
                ):
                    return True
        return False


registry = FaultRegistry()

#: The registry :func:`fire` dispatches to — whichever was armed last
#: (the module singleton by default).
_active: FaultRegistry = registry


def arm(seed: int = 0) -> FaultRegistry:
    return registry.arm(seed)


def disarm() -> None:
    _active.disarm()


def fire(__point: str, **ctx) -> Action | None:
    """The hook-site entry point.  Returns the action of the first
    matching rule that fires, or ``None``.  Disarmed: a single bool
    test (hook sites additionally guard with ``if fp.ARMED:`` so even
    the ``ctx`` dict is never built).  (Positional-only point name so
    context keys like ``name=`` cannot collide.)"""
    if not ARMED:
        return None
    return _active._fire(__point, ctx)


# -- shared action helpers (hook sites interpret, these stay pure) ---------


def delay_seconds(act: Action) -> float:
    """Delay duration for a ``delay``/``stall`` action: fixed
    ``seconds``, or uniform in [seconds, max_seconds] via the rule's
    deterministic parameter draw."""
    lo = float(act.params.get("seconds", 0.0))
    hi = act.params.get("max_seconds")
    if hi is None:
        return lo
    return lo + (float(hi) - lo) * act.params["u"]


def corrupt_bytes(data: bytes, u: float) -> bytes:
    """Flip a few bytes at a draw-determined offset — enough to break
    any MAC/signature over ``data`` without changing its length."""
    if not data:
        return data
    out = bytearray(data)
    i = int(u * len(out)) % len(out)
    out[i] ^= 0xFF
    out[(i * 7 + 13) % len(out)] ^= 0x55
    return bytes(out)


def link_of(addr: str) -> str:
    """Normalize a certificate/post address to a link name the
    partition matcher can compare: scheme and any path stripped —
    ``loop://a01`` → ``a01``, ``http://127.0.0.1:6001/...`` →
    ``127.0.0.1:6001``."""
    if "://" in addr:
        addr = addr.split("://", 1)[1]
    return addr.split("/", 1)[0]
