"""Cross-process trace stitching.

Counterpart of ``bftkv_tpu/obs/stitch.py``.

Each process's :class:`~bftkv_tpu_torch.trace.Tracer` retains only its own
spans: the client write's root lives in the process that issued the
write, the ``server.*`` spans live in every replica that served it,
joined only by the trace id that rode inside the encrypted payload
(``packet.wrap_trace``).  The stitcher is where those fragments become
one tree again: feed it every source's span export and it groups by
trace id, de-duplicates (a collector may re-scrape overlapping
windows), tags each span with the source it came from, and assembles
parent→child trees on demand.

Bounded like everything else in the metrics/trace plane: at most
``max_traces`` traces and ``max_spans_per_trace`` spans each, evicting
oldest-inserted first — sustained fleet traffic cannot grow the
collector without bound.
"""

from __future__ import annotations

from collections import OrderedDict
from bftkv_tpu_torch.devtools.lockwatch import named_lock

__all__ = ["Stitcher"]


class Stitcher:
    def __init__(self, max_traces: int = 256, max_spans_per_trace: int = 512):
        self.max_traces = max_traces
        self.max_spans_per_trace = max_spans_per_trace
        self._lock = named_lock("obs.stitch")
        #: trace id (hex) -> {"spans": {span id: span dict}, "sources": set}
        self._traces: "OrderedDict[str, dict]" = OrderedDict()

    def add(self, source: str, spans: list[dict]) -> int:
        """Ingest one source's exported spans; returns how many were
        new (not seen from any source before)."""
        added = 0
        with self._lock:
            for s in spans:
                tid = s.get("trace")
                sid = s.get("span")
                if not tid or not sid:
                    continue
                t = self._traces.get(tid)
                if t is None:
                    t = self._traces[tid] = {"spans": {}, "sources": set()}
                    while len(self._traces) > self.max_traces:
                        # Newest insertion sits last; eviction takes the
                        # oldest, so ``t`` survives this loop.
                        self._traces.popitem(last=False)
                if sid not in t["spans"]:
                    if len(t["spans"]) >= self.max_spans_per_trace:
                        continue
                    t["spans"][sid] = dict(s, src=source)
                    added += 1
                t["sources"].add(source)
        return added

    # -- views -------------------------------------------------------------

    def summary(self) -> dict:
        with self._lock:
            total = len(self._traces)
            stitched = sum(
                1 for t in self._traces.values() if len(t["sources"]) > 1
            )
        return {"traces": total, "stitched": stitched}

    def traces(self, limit: int = 20, stitched_only: bool = False) -> list[dict]:
        """Newest-inserted last.  Each entry: trace id, root name +
        duration (the longest parentless span, or the longest span when
        every root fragment is missing), span/source counts, and
        ``stitched`` (spans from more than one process)."""
        with self._lock:
            items = [
                (tid, list(t["spans"].values()), sorted(t["sources"]))
                for tid, t in self._traces.items()
            ]
        out = []
        for tid, spans, sources in items:
            if stitched_only and len(sources) <= 1:
                continue
            roots = [s for s in spans if "parent" not in s]
            root = max(
                roots or spans, key=lambda s: s.get("duration", 0.0)
            )
            out.append(
                {
                    "trace_id": tid,
                    "root": root.get("name", "?"),
                    "duration": root.get("duration", 0.0),
                    "spans": len(spans),
                    "sources": sources,
                    "stitched": len(sources) > 1,
                }
            )
        return out[-limit:]

    def spans(self, trace_id: str) -> list[dict] | None:
        """One trace's retained spans as a flat list (the critical-path
        attribution input), or None when the trace was never seen or
        already evicted."""
        with self._lock:
            t = self._traces.get(trace_id)
            return list(t["spans"].values()) if t else None

    def tree(self, trace_id: str) -> dict | None:
        """One trace as a nested tree: ``{"name", "src", "duration",
        "attrs", "children": [...]}``.  Orphan fragments (parent span
        not retained/exported) attach under the synthetic root so
        nothing silently disappears."""
        with self._lock:
            t = self._traces.get(trace_id)
            spans = list(t["spans"].values()) if t else None
        if spans is None:
            return None
        spans.sort(key=lambda s: s.get("start", 0.0))
        nodes = {
            s["span"]: {
                "name": s.get("name", "?"),
                "src": s.get("src", "?"),
                "duration": s.get("duration", 0.0),
                "attrs": s.get("attrs", {}),
                "children": [],
            }
            for s in spans
        }
        root = {"name": "trace", "trace_id": trace_id, "children": []}
        for s in spans:
            node = nodes[s["span"]]
            parent = nodes.get(s.get("parent"))
            (parent["children"] if parent else root["children"]).append(node)
        return root

    def reset(self) -> None:
        with self._lock:
            self._traces.clear()
