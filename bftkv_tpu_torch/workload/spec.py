"""Declarative, seeded-deterministic workload specifications.

Counterpart of ``bftkv_tpu/workload/spec.py``.

A :class:`WorkloadSpec` is a pure description: op mix (read / write /
scan / write_many / gateway-read ratios), key-popularity model
(uniform, zipf, bounded hot set with churn), value-size distribution
(fixed / lognormal) and arrival program (constant open-loop rate,
diurnal ramp, hot-key storm burst, step overload).  Every
probabilistic draw is a pure function of ``(seed, stream, counter)``
through sha256 — the same discipline as ``faults.failpoint._draws`` —
so one seed replays one workload bit-for-bit, across runs AND across
worker counts.

The op stream is indexed by a GLOBAL op index ``g``: worker ``ci`` of
``W`` executes indices ``ci, ci+W, ci+2W, …``, so re-partitioning the
same spec over a different worker count permutes nothing — the op at
index ``g`` (kind, key, size, due time) is identical.  TOFU safety
rides the same arithmetic: a key's owner slot is ``g % owners`` and a
worker count that divides ``owners`` maps every owner slot to exactly
one worker identity (``g ≡ o (mod owners)`` ⇒ ``g ≡ o (mod W)``), so
no variable is ever written by two identities.

Arrival programs compile to a short piecewise-constant segment list
(duration, rate); an op's due time is resolved by walking the ≤10
segments — O(1) per op, never O(ops).
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, fields
from statistics import NormalDist

__all__ = ["OP_KINDS", "Op", "PRESETS", "WorkloadSpec", "flag_overrides",
           "parse_spec"]

#: The closed op-kind enum, in cumulative-draw order.
OP_KINDS = ("write", "read", "scan", "write_many", "gateway_read")

_NORM = NormalDist()


def _uniforms(seed: int, stream: str, counter: int) -> tuple:
    """Four uniforms in [0, 1), a pure function of (seed, stream,
    counter) — the faults-registry draw discipline."""
    h = hashlib.sha256(f"{seed}|{stream}|{counter}".encode()).digest()
    return tuple(
        int.from_bytes(h[8 * i:8 * i + 8], "big") / 2**64 for i in range(4)
    )


@dataclass(frozen=True)
class Op:
    """One scheduled operation: everything the driver needs, resolved
    from the global index alone."""

    index: int
    due_s: float       # scheduled start, seconds from workload t0
    kind: str          # one of OP_KINDS
    owner: int         # owner slot (g % owners): the writing identity
    rank: int          # key rank within the popularity model
    size: int          # value bytes (writes; 0 for reads)


@dataclass
class WorkloadSpec:
    """One workload, fully described.  Mutating a spec after handing it
    to a driver is unsupported (lazy caches assume immutability)."""

    name: str = "custom"
    seed: int = 0
    # -- op mix (weights; normalized, order = OP_KINDS) -------------------
    write: float = 1.0
    read: float = 0.0
    scan: float = 0.0
    write_many: float = 0.0
    gateway_read: float = 0.0
    # -- key popularity ---------------------------------------------------
    keys: str = "uniform"        # uniform | zipf | hotset
    keyspace: int = 512          # ranks per spec (shared namespace)
    zipf_s: float = 1.1
    hot_keys: int = 4            # hotset: bounded hot-set size
    hot_frac: float = 0.9        # hotset: P(draw lands in the hot set)
    churn_every: int = 0         # hotset: ops per hot-set rotation (0=never)
    # -- value sizes ------------------------------------------------------
    values: str = "fixed"        # fixed | lognormal
    value_size: int = 256
    lognorm_mu: float = 5.5      # ln(bytes); e^5.5 ≈ 245 B median
    lognorm_sigma: float = 1.0
    size_min: int = 16
    size_max: int = 65536
    # -- arrival program --------------------------------------------------
    arrival: str = "constant"    # constant | ramp | storm | step
    rate: float = 50.0           # baseline offered ops/s
    duration_s: float = 5.0
    ramp_peak_x: float = 3.0     # ramp: peak rate multiplier (diurnal)
    ramp_steps: int = 8
    storm_start_frac: float = 0.4
    storm_frac: float = 0.2      # storm window, as fractions of duration
    storm_x: float = 4.0         # storm: rate multiplier in the window
    step_at_frac: float = 0.5
    step_x: float = 3.0          # step: overload multiplier after step_at
    # -- structure --------------------------------------------------------
    owners: int = 16             # logical writer-identity slots
    scan_width: int = 4          # keys per scan (read_many)
    wm_batch: int = 3            # items per write_many

    def __post_init__(self):
        if self.keys not in ("uniform", "zipf", "hotset"):
            raise ValueError(f"unknown key model {self.keys!r}")
        if self.values not in ("fixed", "lognormal"):
            raise ValueError(f"unknown value model {self.values!r}")
        if self.arrival not in ("constant", "ramp", "storm", "step"):
            raise ValueError(f"unknown arrival program {self.arrival!r}")
        if self.rate <= 0 or self.duration_s <= 0:
            raise ValueError("rate and duration_s must be positive")
        if self.owners < 1 or self.keyspace < 1:
            raise ValueError("owners and keyspace must be >= 1")
        if abs(self.write + self.read + self.scan + self.write_many
               + self.gateway_read) < 1e-12:
            raise ValueError("op mix is all-zero")
        self._segments: list | None = None
        self._zipf_cdf: list | None = None
        self._hot_cache: tuple | None = None  # (epoch, ranks)

    # -- op mix -----------------------------------------------------------

    def mix_cdf(self) -> tuple:
        w = [getattr(self, k) for k in OP_KINDS]
        total = sum(w)
        acc, out = 0.0, []
        for x in w:
            acc += x / total
            out.append(acc)
        out[-1] = 1.0
        return tuple(out)

    # -- arrival ----------------------------------------------------------

    def segments(self) -> list:
        """Piecewise-constant arrival program:
        ``[(t_start, duration, rate, first_op_index), …]``."""
        if self._segments is not None:
            return self._segments
        d, r = self.duration_s, self.rate
        if self.arrival == "constant":
            raw = [(d, r)]
        elif self.arrival == "ramp":
            # Diurnal half-sine: rate ramps baseline → peak → baseline.
            n = max(self.ramp_steps, 2)
            raw = []
            for i in range(n):
                m = 1.0 + (self.ramp_peak_x - 1.0) * math.sin(
                    math.pi * (i + 0.5) / n
                )
                raw.append((d / n, r * m))
        elif self.arrival == "storm":
            a = d * self.storm_start_frac
            b = d * self.storm_frac
            raw = [(a, r), (b, r * self.storm_x), (d - a - b, r)]
        else:  # step overload
            a = d * self.step_at_frac
            raw = [(a, r), (d - a, r * self.step_x)]
        segs, t, n0 = [], 0.0, 0.0
        for dur, rate in raw:
            if dur <= 0:
                continue
            segs.append((t, dur, rate, n0))
            t += dur
            n0 += dur * rate
        self._segments = segs
        return segs

    def total_ops(self) -> int:
        segs = self.segments()
        t, dur, rate, n0 = segs[-1]
        return int(n0 + dur * rate)

    def mean_rate(self) -> float:
        return round(self.total_ops() / self.duration_s, 2)

    def due(self, g: int) -> float:
        """Scheduled start of op ``g`` (seconds from t0) — walks the
        ≤10 arrival segments, O(1) per op."""
        segs = self.segments()
        for t, dur, rate, n0 in reversed(segs):
            if g >= n0:
                return t + (g - n0) / rate
        t, dur, rate, n0 = segs[0]
        return t + g / rate

    def in_storm(self, t: float) -> bool:
        if self.arrival != "storm":
            return False
        a = self.duration_s * self.storm_start_frac
        return a <= t < a + self.duration_s * self.storm_frac

    # -- key popularity ---------------------------------------------------

    def _zipf_rank(self, u: float) -> int:
        if self._zipf_cdf is None:
            p = [1.0 / (i + 1) ** self.zipf_s for i in range(self.keyspace)]
            total = sum(p)
            acc, cdf = 0.0, []
            for x in p:
                acc += x / total
                cdf.append(acc)
            cdf[-1] = 1.0
            self._zipf_cdf = cdf
        # Binary search: popularity rank 0 is the hottest key.
        cdf = self._zipf_cdf
        lo, hi = 0, len(cdf) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if u <= cdf[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def hot_set(self, epoch: int) -> list[int]:
        """The bounded hot set of ``epoch`` — churn rotates epochs every
        ``churn_every`` ops.  Deterministic, cached for the last epoch."""
        if self._hot_cache is not None and self._hot_cache[0] == epoch:
            return self._hot_cache[1]
        ranks, j = [], 0
        while len(ranks) < min(self.hot_keys, self.keyspace):
            h = hashlib.sha256(
                f"{self.seed}|hotset|{epoch}|{j}".encode()
            ).digest()
            r = int.from_bytes(h[:8], "big") % self.keyspace
            j += 1
            if r not in ranks:
                ranks.append(r)
        self._hot_cache = (epoch, ranks)
        return ranks

    def _rank(self, g: int, due: float, u_key: float, u_hot: float) -> int:
        if self.keys == "zipf":
            return self._zipf_rank(u_key)
        if self.keys == "hotset":
            epoch = g // self.churn_every if self.churn_every > 0 else 0
            # A storm burst concentrates on the hot set entirely.
            frac = 1.0 if self.in_storm(due) else self.hot_frac
            if u_hot < frac:
                hot = self.hot_set(epoch)
                return hot[int(u_key * len(hot))]
        return int(u_key * self.keyspace)

    # -- value sizes ------------------------------------------------------

    def _size(self, u: float) -> int:
        if self.values == "fixed":
            return self.value_size
        # Clamp the uniform off the exact 0/1 poles (inv_cdf is ±inf).
        u = min(max(u, 1e-12), 1.0 - 1e-12)
        b = math.exp(self.lognorm_mu + self.lognorm_sigma * _NORM.inv_cdf(u))
        return max(self.size_min, min(self.size_max, int(b)))

    # -- the op stream ----------------------------------------------------

    def op_at(self, g: int) -> Op:
        u_kind, u_key, u_size, u_hot = _uniforms(self.seed, "op", g)
        cdf = self.mix_cdf()
        kind = OP_KINDS[-1]
        for i, c in enumerate(cdf):
            if u_kind <= c:
                kind = OP_KINDS[i]
                break
        due = self.due(g)
        size = self._size(u_size) if kind in ("write", "write_many") else 0
        return Op(
            index=g,
            due_s=due,
            kind=kind,
            owner=g % self.owners,
            rank=self._rank(g, due, u_key, u_hot),
            size=size,
        )

    def iter_ops(self, start: int = 0, stride: int = 1, limit=None):
        """Worker ``start`` of ``stride``'s slice of the stream: ops
        ``start, start+stride, …`` up to the arrival program's total
        (or ``limit`` ops from this slice)."""
        total = self.total_ops()
        g, done = start, 0
        while g < total and (limit is None or done < limit):
            yield self.op_at(g)
            g += stride
            done += 1

    def key_bytes(self, owner: int, rank: int) -> bytes:
        """Concrete variable name.  The spec name partitions presets
        into disjoint TOFU namespaces; the owner slot pins each key to
        one writing identity."""
        return b"wl/%s/%d/%d" % (self.name.encode(), owner, rank % self.keyspace)

    # -- serialization ----------------------------------------------------

    def canonical(self) -> str:
        """Full ``k=v,…`` string: parses back to an identical spec —
        the subprocess handoff format."""
        out = []
        for f in fields(self):
            v = getattr(self, f.name)
            out.append(f"{f.name}={v}")
        return ",".join(out)

    @classmethod
    def preset(cls, name: str, **over) -> "WorkloadSpec":
        base = PRESETS.get(name)
        if base is None:
            raise ValueError(
                f"unknown workload preset {name!r} "
                f"(have: {', '.join(sorted(PRESETS))})"
            )
        kw = dict(base)
        kw.update(over)
        kw.setdefault("name", name)
        return cls(**kw)


#: Named presets — the bench / nemesis / CLI vocabulary.
PRESETS: dict = {
    # Production read-dominant mix: zipf-popular keys, lognormal values.
    "read_heavy": dict(
        read=0.85, write=0.08, scan=0.03, write_many=0.02,
        gateway_read=0.02, keys="zipf", zipf_s=1.1,
        values="lognormal",
    ),
    # Ingest-dominant mix with batched writes.
    "write_heavy": dict(
        write=0.70, read=0.20, scan=0.02, write_many=0.06,
        gateway_read=0.02, keys="zipf", zipf_s=0.9, value_size=512,
    ),
    # Hot-key storm: a bounded churning hot set, plus a mid-run burst
    # window where the rate multiplies AND every draw lands hot.
    "storm": dict(
        write=0.55, read=0.40, scan=0.02, write_many=0.03,
        keys="hotset", hot_keys=4, hot_frac=0.5, churn_every=64,
        arrival="storm", storm_x=4.0,
    ),
    # Diurnal ramp: baseline → 3x peak → baseline over the run.
    "ramp": dict(
        write=0.40, read=0.55, scan=0.03, write_many=0.02,
        arrival="ramp", ramp_peak_x=3.0,
    ),
    # Write-only constant-rate preset: the cluster_shards fixed-load
    # driver (uniform per-owner keys — no hot-key TOFU races, so the
    # scaling ratio measures sharding, not conflict retries).
    "shards": dict(write=1.0, keys="uniform"),
}

_FIELD_TYPES = {f.name: f.type for f in fields(WorkloadSpec)}


def parse_spec(s: str) -> WorkloadSpec:
    """Parse ``"preset[,k=v,…]"`` or ``"k=v,…"`` into a spec.

    The first comma token may name a preset; every following ``k=v``
    overrides a :class:`WorkloadSpec` field (typed by the dataclass).
    ``parse_spec(spec.canonical())`` round-trips."""
    parts = [p.strip() for p in s.split(",") if p.strip()]
    if not parts:
        raise ValueError("empty workload spec")
    over: dict = {}
    rest = parts
    preset = None
    if "=" not in parts[0]:
        preset = parts[0]
        rest = parts[1:]
    for p in rest:
        if "=" not in p:
            raise ValueError(f"workload spec token {p!r} is not k=v")
        k, v = p.split("=", 1)
        k = k.strip()
        t = _FIELD_TYPES.get(k)
        if t is None:
            raise ValueError(f"unknown workload spec field {k!r}")
        if t in ("int", int):
            over[k] = int(v)
        elif t in ("float", float):
            over[k] = float(v)
        else:
            over[k] = v
    if preset is not None:
        return WorkloadSpec.preset(preset, **over)
    return WorkloadSpec(**over)


def flag_overrides() -> dict:
    """The ``BFTKV_WORKLOAD_SEED`` / ``BFTKV_WORKLOAD_RATE`` /
    ``BFTKV_WORKLOAD_DURATION`` env knobs (flags.py, "Workload
    engine"), resolved into spec-field overrides.  One read path for
    every consumer — the bench sections splice the returned dict over
    their per-section defaults, so an operator can re-seed or re-rate
    a round without editing configs.  Unset flags are absent from the
    dict (callers keep their defaults)."""
    from bftkv_tpu_torch import flags

    over: dict = {}
    seed = flags.get_int("BFTKV_WORKLOAD_SEED")
    if seed is not None:
        over["seed"] = seed
    rate = flags.get_float("BFTKV_WORKLOAD_RATE")
    if rate is not None:
        over["rate"] = rate
    duration = flags.get_float("BFTKV_WORKLOAD_DURATION")
    if duration is not None:
        over["duration_s"] = duration
    return over
