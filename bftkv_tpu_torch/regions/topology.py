"""Named geo-topologies compiled onto the failpoint link plane (counterpart of ``bftkv_tpu/regions/topology.py``).

An :class:`RttMatrix` is a deterministic description of inter-region
round-trip times; a :class:`LinkDelayProgram` compiles it into quiet
*background* ``delay`` rules on the ``transport.send`` failpoint —
one per ordered region pair — so any in-process fleet runs under a
named geography (e.g. three regions at 20/80/150 ms) with zero code
changes at the hook sites.  Two properties distinguish a topology
from a fault:

- **Quiet**: topology rules never enter the fault trace, never count
  ``faults.fired``, and therefore never surface as ``fault_injected``
  anomalies — geography is an environment, not an event.
- **Background**: topology rules are evaluated only after every
  foreground rule declined, so a nemesis step armed *later* at the
  same point (a partition drop, a Byzantine handler) always wins the
  first-match dispatch.

Spec grammar (milliseconds, ``/``-separated, deterministic given the
sorted region list ``r0 < r1 < ...``):

- ``len == n(n-1)/2`` values — pairwise cross-region RTTs in
  ``(r0,r1), (r0,r2), ..., (r1,r2), ...`` order, intra-region 0;
- ``len == 1 + n(n-1)/2`` values — the first value is the (shared)
  intra-region RTT, the rest pairwise as above.

So ``wan3`` = ``20/80/150`` over three regions reads: r0↔r1 20 ms,
r0↔r2 80 ms, r1↔r2 150 ms; and ``wan2`` = ``20/60`` over two regions
reads: 20 ms within a region, 60 ms across.  One-way link delay is
RTT/2; ``BFTKV_WAN_JITTER`` stretches each delay uniformly (seeded
per-rule draw) up to ``delay × (1 + jitter)``.
"""

from __future__ import annotations

import itertools

from bftkv_tpu_torch import flags

__all__ = [
    "NAMED",
    "RttMatrix",
    "LinkDelayProgram",
    "install_matrix",
]

#: Named topologies the CLI knobs accept (``--rtt-matrix wan3``).
NAMED: dict[str, str] = {
    # 2 regions: 20 ms intra, 60 ms cross — the CI WAN-smoke shape.
    "wan2": "20/60",
    # 3 regions: pairwise 20/80/150 ms cross, 0 intra — the
    # cluster_wan benchmark shape.
    "wan3": "20/80/150",
}


class RttMatrix:
    """Symmetric inter-region RTT matrix (seconds internally)."""

    def __init__(
        self,
        name: str,
        regions: list[str],
        intra_s: float,
        cross_s: dict,
    ):
        self.name = name
        self.regions = sorted(regions)
        self.intra_s = float(intra_s)
        #: ``{(ra, rb) sorted tuple: rtt seconds}``
        self.cross_s = dict(cross_s)

    @classmethod
    def parse(cls, spec: str, regions: list[str]) -> "RttMatrix":
        """Parse a named topology or a raw ms spec against the fleet's
        sorted region list."""
        name = spec.strip()
        raw = NAMED.get(name, name)
        regions = sorted(set(regions))
        n = len(regions)
        if n < 2:
            raise ValueError(
                f"rtt matrix needs >= 2 regions, fleet has {n}"
            )
        try:
            vals = [float(v) / 1000.0 for v in raw.split("/") if v != ""]
        except ValueError:
            raise ValueError(f"bad rtt matrix spec {spec!r}") from None
        pairs = list(itertools.combinations(regions, 2))
        if len(vals) == len(pairs):
            intra, cross_vals = 0.0, vals
        elif len(vals) == len(pairs) + 1:
            intra, cross_vals = vals[0], vals[1:]
        else:
            raise ValueError(
                f"rtt matrix {spec!r} has {len(vals)} value(s); "
                f"{n} regions need {len(pairs)} (pairwise) or "
                f"{len(pairs) + 1} (intra + pairwise)"
            )
        cross = {p: v for p, v in zip(pairs, cross_vals)}
        label = name if name in NAMED else "wan"
        return cls(label, regions, intra, cross)

    def rtt(self, a: str, b: str) -> float:
        """RTT in seconds between two (known) regions."""
        if a == b:
            return self.intra_s
        key = (a, b) if a <= b else (b, a)
        return self.cross_s[key]

    def max_cross_s(self) -> float:
        return max(self.cross_s.values(), default=0.0)

    def min_cross_s(self) -> float:
        return min(self.cross_s.values(), default=0.0)

    def describe(self) -> dict:
        return {
            "name": self.name,
            "regions": self.regions,
            "intra_ms": round(self.intra_s * 1000.0, 3),
            "cross_ms": {
                f"{a}-{b}": round(v * 1000.0, 3)
                for (a, b), v in sorted(self.cross_s.items())
            },
        }


class LinkDelayProgram:
    """Compile an :class:`RttMatrix` onto a fault registry as quiet
    background one-way delay rules (delay = RTT/2 per direction)."""

    def __init__(self, matrix: RttMatrix, jitter: float | None = None):
        self.matrix = matrix
        if jitter is None:
            jitter = flags.get_float("BFTKV_WAN_JITTER") or 0.0
        self.jitter = max(float(jitter), 0.0)
        self.rules: list = []

    def _match(self, ra: str, rb: str):
        from bftkv_tpu_torch.regions import regionmap

        def crosses(ctx: dict) -> bool:
            return (
                regionmap.region_of(ctx.get("src")) == ra
                and regionmap.region_of(ctx.get("dst")) == rb
            )

        return crosses

    def install(self, registry) -> list:
        """Arm one rule per ordered region pair with a nonzero one-way
        delay.  Endpoints with no region label (collector probes,
        unlabeled principals) never match — geography only binds the
        labeled fleet."""
        rules = []
        for ra, rb in itertools.product(self.matrix.regions, repeat=2):
            one_way = self.matrix.rtt(ra, rb) / 2.0
            if one_way <= 0.0:
                continue
            kwargs = {"seconds": one_way}
            if self.jitter > 0.0:
                kwargs["max_seconds"] = one_way * (1.0 + self.jitter)
            rules.append(
                registry.add(
                    "transport.send",
                    "delay",
                    match=self._match(ra, rb),
                    rule_id=f"wan.{self.matrix.name}.{ra}->{rb}",
                    quiet=True,
                    background=True,
                    **kwargs,
                )
            )
        self.rules = rules
        return rules

    def uninstall(self, registry) -> None:
        registry.remove_all(self.rules)
        self.rules = []


def install_matrix(
    registry,
    spec: str,
    regions: list[str] | None = None,
    jitter: float | None = None,
) -> tuple[RttMatrix, LinkDelayProgram]:
    """One-call geography: parse ``spec`` against ``regions`` (default:
    the installed :data:`~bftkv_tpu_torch.regions.regionmap`'s labels), hand
    the matrix to the region map for distance ranking, and arm the
    delay program on ``registry``."""
    from bftkv_tpu_torch.regions import regionmap

    if regions is None:
        regions = regionmap.regions()
    matrix = RttMatrix.parse(spec, regions)
    regionmap.set_rtt(matrix)
    program = LinkDelayProgram(matrix, jitter=jitter)
    program.install(registry)
    return matrix, program
