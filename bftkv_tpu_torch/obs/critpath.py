"""Critical-path attribution: who owns a write's wall clock.

Counterpart of ``bftkv_tpu/obs/critpath.py``.

The write collapsed to one round and its crypto moved into a shared
sidecar — and with every such move, "the write is slow" became harder
to localize: the latency can hide in the presession
lease, the WRITE_SIGN fan-out machinery, the slowest peer's wire time,
the server's admission + verify, the batching dispatcher's queue, the
sidecar round trip, or the collective combine ("The Latency Price of
Threshold Cryptosystems" frames exactly this: threshold systems pay
their latency price in stragglers and pipelining gaps, not means).
``round_p50_s`` (the bench's round breakdown) reports per-phase medians of
*independent* spans; it cannot say what fraction of one p99 write each
phase owned.

This module decomposes a stitched trace tree (the
:class:`~bftkv_tpu_torch.obs.stitch.Stitcher` output, or any span-dict list)
into an **exclusive-time budget** over the closed
:data:`bftkv_tpu_torch.trace.PHASES` enum:

- each span's *self time* is its duration minus the interval UNION of
  its children (overlapping children — parallel RPCs — are counted
  once, never summed past wall clock);
- time covered by several overlapping siblings is attributed to the
  LAST-ENDING one — the straggler owns the overlap, because the
  straggler is what the caller actually waited on;
- children are clipped to their parent's interval, so an async tail
  that outlives the root (back-fill after early commit) never inflates
  the budget past the root's duration — by construction the per-phase
  exclusive times sum to exactly the root span's duration.

:class:`PhaseBudget` aggregates budgets per (op, shard) into
fixed-bucket histograms on the fleet-wide ``metrics.BUCKETS`` ladder —
mergeable across collectors by bucket-vector summation, same design as
the SLO histograms (DESIGN.md §11.2) — and retains the slowest traces
as exemplars so ``/fleet`` reports the phase breakdown of the **p99
exemplar**, not the mean.  Design: docs/DESIGN.md §18.
"""

from __future__ import annotations

import heapq

from bftkv_tpu_torch.metrics import BUCKETS, _bucket_index, histogram_quantile
from bftkv_tpu_torch.trace import PHASES, phase_of
from bftkv_tpu_torch.devtools.lockwatch import named_lock

__all__ = ["PhaseBudget", "ROOT_OPS", "attribute"]

#: Root span names the attribution plane decomposes, and the op each
#: reports under.  Closed on purpose: write_many/read_many roots have
#: batch semantics (N items amortize one round) that would pollute the
#: single-op budget.
ROOT_OPS = {
    "client.write": "write",
    "client.read": "read",
    "client.read_certified": "read",
}

# ---------------------------------------------------------------------------
# Interval algebra.  An interval set is a sorted, disjoint tuple of
# (start, end) pairs; all helpers preserve that invariant.
# ---------------------------------------------------------------------------


def _clip(iv: tuple, lo: float, hi: float) -> tuple:
    out = []
    for s, e in iv:
        s2, e2 = max(s, lo), min(e, hi)
        if e2 > s2:
            out.append((s2, e2))
    return tuple(out)


def _subtract(iv: tuple, minus: tuple) -> tuple:
    """``iv − minus`` (both interval sets)."""
    out = []
    for s, e in iv:
        segs = [(s, e)]
        for ms, me in minus:
            nxt = []
            for ss, se in segs:
                if me <= ss or ms >= se:
                    nxt.append((ss, se))
                    continue
                if ms > ss:
                    nxt.append((ss, ms))
                if me < se:
                    nxt.append((me, se))
            segs = nxt
            if not segs:
                break
        out.extend(segs)
    return tuple(sorted(out))


def _measure(iv: tuple) -> float:
    return sum(e - s for s, e in iv)


# ---------------------------------------------------------------------------
# One-trace attribution.
# ---------------------------------------------------------------------------


def _span_interval(s: dict) -> tuple[float, float]:
    start = float(s.get("start", 0.0))
    return start, start + max(float(s.get("duration", 0.0)), 0.0)


def attribute(spans: list[dict]) -> dict | None:
    """Decompose one trace's root span into the per-phase exclusive-
    time budget.  ``spans`` is any list of span dicts (one trace) in
    ``Span.to_dict`` / stitcher form.  Returns ``None`` when the trace
    has no :data:`ROOT_OPS` root; otherwise::

        {"op", "shard", "trace_id", "root_s",
         "phases": {phase: seconds},   # sums to root_s exactly
         "attributed_s"}               # root_s minus clock-skew loss

    Cross-process clock skew can push a stitched child outside its
    parent's wall-clock window; such children are clipped (possibly to
    nothing) and their time stays with the parent's phase — the budget
    degrades toward coarser attribution, never toward double counting.
    """
    root = None
    for s in spans:
        if "parent" not in s and s.get("name") in ROOT_OPS:
            root = s
            break
    if root is None:
        return None
    children: dict[str, list[dict]] = {}
    for s in spans:
        p = s.get("parent")
        if p is not None and s.get("span") != root.get("span"):
            children.setdefault(p, []).append(s)

    budget = dict.fromkeys(PHASES, 0.0)
    r0, r1 = _span_interval(root)

    def walk(span: dict, owned: tuple, depth: int = 0) -> None:
        if not owned or depth > 64:  # defensive: hostile/cyclic input
            return
        kids = children.get(span.get("span"), ())
        claimed: tuple = ()
        # Straggler-first: the last-ending sibling claims its full
        # interval; earlier-ending overlappers claim what is left.  The
        # overlap therefore lands on the span the caller waited on.
        for kid in sorted(
            kids, key=lambda k: _span_interval(k)[1], reverse=True
        ):
            ks, ke = _span_interval(kid)
            own = _subtract(_clip(owned, ks, ke), claimed)
            if own:
                walk(kid, own, depth + 1)
                claimed = tuple(sorted(claimed + own))
        phase = span.get("phase") or phase_of(span.get("name", ""))
        if phase not in budget:
            phase = "other"
        budget[phase] += _measure(_subtract(owned, claimed))

    walk(root, ((r0, r1),) if r1 > r0 else ())
    attributed = sum(budget.values())
    shard = (root.get("attrs") or {}).get("shard")
    return {
        "op": ROOT_OPS[root["name"]],
        "shard": shard if isinstance(shard, int) else None,
        "trace_id": root.get("trace"),
        "root_s": max(r1 - r0, 0.0),
        "phases": budget,
        "attributed_s": attributed,
    }


# ---------------------------------------------------------------------------
# Aggregation: mergeable per-phase histograms + p99 exemplars.
# ---------------------------------------------------------------------------


class PhaseBudget:
    """Per-(op, shard) phase budgets as fixed-bucket histograms.

    Bucket vectors ride the fleet-wide ``metrics.BUCKETS`` ladder, so
    two PhaseBudgets (two collectors, two bench runs) merge by vector
    summation — the same property the SLO plane leans on.  The slowest
    ``max_exemplars`` traces per (op, shard) are retained with their
    full breakdown; :meth:`doc` reports the one sitting at the merged
    p99 (smallest retained root ≥ the histogram's p99 estimate, else
    the slowest) — stragglers are the point, means hide them."""

    def __init__(self, max_exemplars: int = 8):
        self.max_exemplars = max_exemplars
        self._lock = named_lock("obs.critpath")
        #: (op, shard, phase) -> [bucket counts] (len(BUCKETS)+1)
        self._phase_hist: dict[tuple, list[int]] = {}
        #: (op, shard, phase) -> cumulative seconds
        self._phase_sum: dict[tuple, float] = {}
        #: (op, shard) -> [bucket counts] of root durations
        self._root_hist: dict[tuple, list[int]] = {}
        self._root_count: dict[tuple, int] = {}
        self._root_sum: dict[tuple, float] = {}
        #: (op, shard) -> min-heap of (root_s, seq, breakdown)
        self._exemplars: dict[tuple, list] = {}
        self._seq = 0

    # Same ladder, same bucketing as the SLO histograms — the merge
    # property depends on it, so share the helper instead of forking.
    _bucket = staticmethod(_bucket_index)

    def observe(self, breakdown: dict) -> None:
        """Fold one :func:`attribute` result in."""
        op = breakdown["op"]
        shard = breakdown["shard"] or 0
        key = (op, shard)
        with self._lock:
            for phase, secs in breakdown["phases"].items():
                pk = (op, shard, phase)
                h = self._phase_hist.get(pk)
                if h is None:
                    h = self._phase_hist[pk] = [0] * (len(BUCKETS) + 1)
                h[self._bucket(secs)] += 1
                self._phase_sum[pk] = self._phase_sum.get(pk, 0.0) + secs
            rh = self._root_hist.get(key)
            if rh is None:
                rh = self._root_hist[key] = [0] * (len(BUCKETS) + 1)
            rh[self._bucket(breakdown["root_s"])] += 1
            self._root_count[key] = self._root_count.get(key, 0) + 1
            self._root_sum[key] = (
                self._root_sum.get(key, 0.0) + breakdown["root_s"]
            )
            heap = self._exemplars.setdefault(key, [])
            self._seq += 1
            item = (breakdown["root_s"], self._seq, breakdown)
            if len(heap) < self.max_exemplars:
                heapq.heappush(heap, item)
            elif item[0] > heap[0][0]:
                heapq.heapreplace(heap, item)

    def merge(self, other: "PhaseBudget") -> None:
        """Fold ``other`` in (bucket-vector summation; exemplars
        re-ranked by root duration).  The cross-member merge property
        the fixed ladder buys."""
        with other._lock:
            ph = {k: list(v) for k, v in other._phase_hist.items()}
            ps = dict(other._phase_sum)
            rh = {k: list(v) for k, v in other._root_hist.items()}
            rc = dict(other._root_count)
            rs = dict(other._root_sum)
            ex = {k: list(v) for k, v in other._exemplars.items()}
        with self._lock:
            for k, v in ph.items():
                mine = self._phase_hist.setdefault(
                    k, [0] * (len(BUCKETS) + 1)
                )
                for i, c in enumerate(v):
                    mine[i] += c
            for k, v in ps.items():
                self._phase_sum[k] = self._phase_sum.get(k, 0.0) + v
            for k, v in rh.items():
                mine = self._root_hist.setdefault(
                    k, [0] * (len(BUCKETS) + 1)
                )
                for i, c in enumerate(v):
                    mine[i] += c
            for k, v in rc.items():
                self._root_count[k] = self._root_count.get(k, 0) + v
            for k, v in rs.items():
                self._root_sum[k] = self._root_sum.get(k, 0.0) + v
            for k, items in ex.items():
                heap = self._exemplars.setdefault(k, [])
                for item in items:
                    self._seq += 1
                    item = (item[0], self._seq, item[2])
                    if len(heap) < self.max_exemplars:
                        heapq.heappush(heap, item)
                    elif item[0] > heap[0][0]:
                        heapq.heapreplace(heap, item)

    def _p99_exemplar(self, key: tuple) -> dict | None:
        """The retained trace nearest the merged p99 from above."""
        heap = self._exemplars.get(key)
        if not heap:
            return None
        p99 = histogram_quantile(0.99, self._root_hist.get(key, ()))
        candidates = sorted(heap, key=lambda it: it[0])
        for root_s, _seq, breakdown in candidates:
            if p99 is None or root_s >= p99 or root_s >= BUCKETS[-1]:
                return breakdown
        return candidates[-1][2]  # merged p99 above every retained root

    def doc(self) -> dict:
        """``{op: {shard: {"count", "root_sum_s", "phases": {phase:
        {"sum_s", "share", "buckets"}}, "p99_exemplar": {...}}}}`` —
        the ``/fleet`` ``write_budget_by_phase`` surface.  Bucket
        vectors ride along so any consumer can merge further."""
        with self._lock:
            keys = sorted(self._root_count)
            out: dict = {}
            for op, shard in keys:
                total = self._root_sum.get((op, shard), 0.0)
                phases = {}
                for phase in PHASES:
                    pk = (op, shard, phase)
                    if pk not in self._phase_hist:
                        continue
                    s = self._phase_sum.get(pk, 0.0)
                    phases[phase] = {
                        "sum_s": round(s, 6),
                        "share": round(s / total, 4) if total else 0.0,
                        "buckets": list(self._phase_hist[pk]),
                    }
                ex = self._p99_exemplar((op, shard))
                out.setdefault(op, {})[shard] = {
                    "count": self._root_count[(op, shard)],
                    "root_sum_s": round(total, 6),
                    "root_p99_le_s": histogram_quantile(
                        0.99, self._root_hist.get((op, shard), ())
                    ),
                    "phases": phases,
                    "p99_exemplar": (
                        {
                            "trace_id": ex["trace_id"],
                            "root_s": round(ex["root_s"], 6),
                            "phases": {
                                p: round(v, 6)
                                for p, v in ex["phases"].items()
                                if v > 0.0
                            },
                        }
                        if ex
                        else None
                    ),
                }
            return out

    @staticmethod
    def fleet_shares(budget_doc: dict, op: str = "write") -> dict:
        """Fleet-wide ``{phase: share}`` over one op, each shard's
        shares weighted by the wall clock that shard's roots actually
        spent (``root_sum_s``) — the verdict join's input (§20): a
        phase dominating a busy shard outweighs the same phase idling
        on a quiet one.  Empty before any trace was attributed."""
        agg: dict[str, float] = {}
        total = 0.0
        for sh_doc in budget_doc.get(op, {}).values():
            w = sh_doc.get("root_sum_s") or 0.0
            if w <= 0:
                continue
            total += w
            for ph, pd in (sh_doc.get("phases") or {}).items():
                agg[ph] = agg.get(ph, 0.0) + w * (pd.get("share") or 0.0)
        return {ph: v / total for ph, v in agg.items()} if total else {}

    def reset(self) -> None:
        with self._lock:
            self._phase_hist.clear()
            self._phase_sum.clear()
            self._root_hist.clear()
            self._root_count.clear()
            self._root_sum.clear()
            self._exemplars.clear()
