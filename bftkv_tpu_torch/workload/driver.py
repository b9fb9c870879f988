"""Workload execution: open-loop scheduling, CO-corrected latency,
in-process and multi-process drivers (counterpart of
``bftkv_tpu/workload/driver.py``).

Latency discipline (the coordinated-omission correction): every op has
a SCHEDULED start from the spec's arrival program, and its recorded
latency runs from that due time — a backed-up system shows its queueing
delay instead of quietly slowing the offered load the way a closed
loop does.  When the scheduler itself falls behind (sustained
overload), the op still charges from its due time AND the backlog is
reported (``ops_behind``, ``max_sched_lag_s``) — never silently
absorbed.

Latencies land on the fleet-wide ``metrics.BUCKETS`` ladder
(:class:`LatencyHist`), so per-worker and per-process histograms merge
by bucket-vector summation into one offered/achieved/p50/p99 report —
the same fixed-ladder design the fleet collector uses (per-worker
sample quantiles cannot be merged; the p99 of a set of p99s is
meaningless).

The multi-process driver escapes the in-process GIL wall: each
worker is its own interpreter with its own identity (a saved home
directory), talking to the cluster over the real HTTP transport, with
its dispatchers and client on the ``--device`` it is given (default
``cuda:0``, which raises without CUDA).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

from bftkv_tpu_torch.metrics import BUCKETS, histogram_quantile
from bftkv_tpu_torch.workload.spec import WorkloadSpec, parse_spec

__all__ = [
    "LatencyHist", "OpenLoop", "Pacer", "execute_op", "merge_reports",
    "run_in_process", "run_multiprocess",
]


class Pacer:
    """Wall-clock gate for scheduled ops, with backlog accounting.

    ``wait_until(due_s, ci)`` sleeps until ``t0 + due_s`` and returns
    the absolute due time.  A worker arriving LATE does not sleep —
    the op runs immediately, its latency is still measured from the
    scheduled start, and the scheduling lag is recorded per worker
    (plain per-slot writes: no lock needed, merged on read).  Lag
    under 1 ms is scheduler noise (op 0 is due exactly at t0), not
    backlog."""

    GRACE_S = 1e-3

    def __init__(self, workers: int, t0: float | None = None):
        self.t0 = time.perf_counter() if t0 is None else t0
        self._behind = [0] * workers
        self._lag = [0.0] * workers

    def wait_until(self, due_s: float, ci: int = 0) -> float:
        due = self.t0 + due_s
        delay = due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        elif delay < -self.GRACE_S:
            self._behind[ci] += 1
            if -delay > self._lag[ci]:
                self._lag[ci] = -delay
        return due

    def backlog(self) -> dict:
        return {
            "ops_behind": sum(self._behind),
            "max_sched_lag_s": round(max(self._lag), 4),
        }


class OpenLoop:
    """Constant-rate open-loop schedule for one worker pool: ``rate``
    ops/s spread evenly over ``workers`` workers; worker ``ci``'s
    ``k``-th op is DUE at ``t0 + (k·workers + ci)/rate``.  The bench
    harness's historical ``_OpenLoop``, now with the :class:`Pacer`
    backlog accounting — at sustained overload the scheduler reports
    how far behind it ran instead of silently absorbing it."""

    def __init__(self, rate: float, workers: int):
        self.rate = rate
        self.workers = workers
        self._pacer = Pacer(workers)

    @property
    def t0(self) -> float:
        return self._pacer.t0

    def due(self, ci: int, k: int) -> float:
        return self.t0 + (k * self.workers + ci) / self.rate

    def wait(self, ci: int, k: int) -> float:
        """Sleep until op (ci, k) is due; returns the due time (the
        latency measurement origin, behind or not)."""
        return self._pacer.wait_until(
            (k * self.workers + ci) / self.rate, ci
        )

    def backlog(self) -> dict:
        return self._pacer.backlog()


class LatencyHist:
    """Fixed-ladder latency histogram on ``metrics.BUCKETS`` — the
    mergeable unit of the multi-process report."""

    __slots__ = ("counts", "n", "total")

    def __init__(self, counts=None, n: int = 0, total: float = 0.0):
        self.counts = list(counts) if counts else [0] * (len(BUCKETS) + 1)
        if len(self.counts) != len(BUCKETS) + 1:
            raise ValueError("bucket vector does not match the ladder")
        self.n = n
        self.total = total

    def observe(self, v: float) -> None:
        lo, hi = 0, len(BUCKETS)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= BUCKETS[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.n += 1
        self.total += v

    def merge(self, other: "LatencyHist") -> "LatencyHist":
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.n += other.n
        self.total += other.total
        return self

    def quantile(self, q: float):
        return histogram_quantile(q, self.counts)

    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def to_dict(self) -> dict:
        return {"counts": self.counts, "n": self.n,
                "total": round(self.total, 6)}

    @classmethod
    def from_dict(cls, d: dict) -> "LatencyHist":
        return cls(d["counts"], d["n"], d["total"])


def execute_op(client, spec: WorkloadSpec, op, blob: bytes,
               gateway=None) -> str:
    """Run one op against ``client``; returns the kind actually
    executed (``gateway_read`` degrades to ``read`` without a
    gateway).  Values are slices of ``blob`` offset by the op index —
    cheap, size-exact, content-irrelevant."""
    key = spec.key_bytes(op.owner, op.rank)
    if op.kind == "write":
        off = op.index % max(len(blob) - op.size, 1)
        client.write(key, blob[off:off + op.size])
        return "write"
    if op.kind == "write_many":
        nb = min(spec.wm_batch, spec.keyspace)
        off = op.index % max(len(blob) - op.size, 1)
        val = blob[off:off + op.size]
        items = [
            (spec.key_bytes(op.owner, op.rank + j), val) for j in range(nb)
        ]
        res = client.write_many(items)
        errs = [e for e in res if e is not None]
        if errs:
            raise errs[0]
        return "write_many"
    if op.kind == "scan":
        keys = [
            spec.key_bytes(op.owner, op.rank + j)
            for j in range(min(spec.scan_width, spec.keyspace))
        ]
        client.read_many(keys)
        return "scan"
    if op.kind == "gateway_read" and gateway is not None:
        gateway.read(key)
        return "gateway_read"
    client.read(key)
    return "read"


def _run_slice(
    spec: WorkloadSpec, client, ci: int, stride: int, pacer: Pacer,
    hist: LatencyHist, kinds: dict, errors: list, blob: bytes,
    gateway=None, max_ops=None,
) -> int:
    """Worker ``ci``'s slice of the global op stream.  Returns the op
    count executed (errors included — an errored op still consumed its
    arrival slot)."""
    done = 0
    for op in spec.iter_ops(ci, stride, max_ops):
        due = pacer.wait_until(op.due_s, ci)
        try:
            kind = execute_op(client, spec, op, blob, gateway)
            kinds[kind] = kinds.get(kind, 0) + 1
        except Exception as e:
            if len(errors) < 8:
                errors.append(f"{op.kind}@{op.index}: "
                              f"{type(e).__name__}: {e}")
            kinds["error"] = kinds.get("error", 0) + 1
        hist.observe(time.perf_counter() - due)
        done += 1
    return done


def _report(spec: WorkloadSpec, hist: LatencyHist, kinds: dict,
            errors: list, backlog: dict, elapsed: float, done: int,
            workers: int, mode: str) -> dict:
    return {
        "spec": spec.canonical(),
        "preset": spec.name,
        "mode": mode,
        "workers": workers,
        "offered_rate_per_sec": spec.mean_rate(),
        "offered_ops": done,
        "achieved_rate_per_sec": round(done / elapsed, 2) if elapsed else 0,
        "elapsed_s": round(elapsed, 3),
        # Ladder quantiles measured from each op's SCHEDULED start —
        # bucket upper bounds, mergeable across processes.
        "p50_offered_s": hist.quantile(0.5) or 0,
        "p99_offered_s": hist.quantile(0.99) or 0,
        "mean_offered_s": round(hist.mean(), 4),
        "lat_buckets": list(hist.counts),
        "ops": dict(sorted(kinds.items())),
        "errors": kinds.get("error", 0),
        "error_samples": errors,
        "backlog": backlog,
    }


def run_in_process(
    spec: WorkloadSpec, clients: list, *, workers: int | None = None,
    gateway=None, max_ops_per_worker=None,
) -> dict:
    """Drive ``spec`` with ``workers`` threads over in-process clients
    (worker ``ci`` owns every owner slot ≡ ci mod workers, so TOFU
    ownership is single-writer by construction)."""
    w = workers or len(clients)
    if w < 1 or w > len(clients):
        raise ValueError(f"workers={w} outside 1..{len(clients)}")
    if spec.owners % w:
        raise ValueError(
            f"worker count {w} must divide spec.owners={spec.owners} "
            "(owner→identity stability across worker counts)"
        )
    blob = os.urandom(spec.size_max + 1)
    pacer = Pacer(w)
    hists = [LatencyHist() for _ in range(w)]
    kinds: list[dict] = [{} for _ in range(w)]
    errors: list[list] = [[] for _ in range(w)]
    counts = [0] * w

    def run(ci: int) -> None:
        counts[ci] = _run_slice(
            spec, clients[ci], ci, w, pacer, hists[ci], kinds[ci],
            errors[ci], blob, gateway, max_ops_per_worker,
        )

    threads = [
        threading.Thread(target=run, args=(ci,), daemon=True)
        for ci in range(w)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t0
    hist = LatencyHist()
    all_kinds: dict = {}
    all_errors: list = []
    for ci in range(w):
        hist.merge(hists[ci])
        for k, v in kinds[ci].items():
            all_kinds[k] = all_kinds.get(k, 0) + v
        all_errors.extend(errors[ci][: max(0, 8 - len(all_errors))])
    return _report(
        spec, hist, all_kinds, all_errors, pacer.backlog(), elapsed,
        sum(counts), w, "in_process",
    )


def merge_reports(reports: list[dict], spec: WorkloadSpec,
                  workers: int) -> dict:
    """Fleet merge: bucket-vector summation across worker processes.
    Quantiles come from the merged vector — identical to a
    single-stream histogram of the same observations (the fixed-ladder
    merge law the tests pin down)."""
    hist = LatencyHist()
    kinds: dict = {}
    errors: list = []
    done = 0
    elapsed = 0.0
    behind, lag = 0, 0.0
    for r in reports:
        hist.merge(LatencyHist(r["lat_buckets"],
                               sum(r["lat_buckets"]), 0.0))
        hist.total += r.get("lat_total_s", 0.0)
        for k, v in r.get("ops", {}).items():
            kinds[k] = kinds.get(k, 0) + v
        errors.extend(r.get("error_samples", [])[: max(0, 8 - len(errors))])
        done += r.get("offered_ops", 0)
        elapsed = max(elapsed, r.get("elapsed_s", 0.0))
        b = r.get("backlog", {})
        behind += b.get("ops_behind", 0)
        lag = max(lag, b.get("max_sched_lag_s", 0.0))
    hist.n = sum(hist.counts)
    return _report(
        spec, hist, kinds, errors,
        {"ops_behind": behind, "max_sched_lag_s": round(lag, 4)},
        elapsed, done, workers, "multi_process",
    )


def run_multiprocess(
    spec: WorkloadSpec, cluster, homes_dir: str, *, procs: int | None = None,
    timeout_s: float = 300.0, device=None, max_ops_per_worker: int | None = None,
) -> dict:
    """Drive ``spec`` with ``procs`` WORKER PROCESSES over the HTTP
    transport against a running cluster (tests/cluster_utils shape,
    ``transport="http"``, at least ``procs`` users).

    Each worker loads its own saved home (its identity + the full
    certificate view), builds a real client, and executes its slice of
    the same global op stream; the parent merges the per-process
    bucket vectors.  This is the GIL escape: interpreter-parallel
    clients, one offered-load schedule.

    ``procs=None`` reads the ``BFTKV_WORKLOAD_PROCS`` flag (default 2)
    — the operator knob for sizing the driver pair to the box.
    ``device`` (``None``: ``cuda:0``, which raises here without CUDA) is
    passed to every worker as ``--device``; ``max_ops_per_worker`` stops
    each worker after that many ops of its slice (``--max-ops``)."""
    from bftkv_tpu_torch import device as devmod
    from bftkv_tpu_torch import flags, topology

    device = str(devmod.resolve(device))

    if procs is None:
        procs = flags.get_int("BFTKV_WORKLOAD_PROCS") or 2
    uni = cluster.universe
    if len(uni.users) < procs:
        raise ValueError(f"cluster has {len(uni.users)} users < {procs}")
    if spec.owners % procs:
        raise ValueError(
            f"procs={procs} must divide spec.owners={spec.owners}"
        )
    homes = []
    for i in range(procs):
        ident = uni.users[i]
        home = os.path.join(homes_dir, f"worker{i}")
        if not os.path.isdir(home):
            topology.save_home(home, ident, uni.view_of(ident))
        homes.append(home)
    start_at = time.time() + 2.0 + 0.25 * procs  # overlap gate
    outs, children = [], []
    env = dict(os.environ)
    for i, home in enumerate(homes):
        out = os.path.join(homes_dir, f"worker{i}.json")
        outs.append(out)
        children.append(subprocess.Popen(
            [
                sys.executable, "-m", "bftkv_tpu_torch.workload.driver",
                "--home", home, "--spec", spec.canonical(),
                "--worker", str(i), "--workers", str(procs),
                "--start-at", str(start_at), "--out", out,
                "--device", device,
                "--max-ops", str(max_ops_per_worker or 0),
            ],
            env=env,
        ))
    reports = []
    for child, out in zip(children, outs):
        try:
            child.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()
        try:
            with open(out) as f:
                reports.append(json.load(f))
        except Exception:
            pass
    if not reports:
        raise RuntimeError("every workload worker process failed")
    merged = merge_reports(reports, spec, procs)
    merged["worker_reports"] = len(reports)
    return merged


def _worker_main(argv: list[str]) -> None:
    """One worker process: load home, dial the cluster, run the slice."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--home", required=True)
    ap.add_argument("--spec", required=True)
    ap.add_argument("--worker", type=int, required=True)
    ap.add_argument("--workers", type=int, required=True)
    ap.add_argument("--start-at", type=float, default=0.0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--max-ops", type=int, default=0)
    ap.add_argument("--device", default="cuda:0",
                    help="device of the worker's dispatchers and client "
                         "(default cuda:0, which raises without CUDA)")
    args = ap.parse_args(argv)

    from bftkv_tpu_torch import device as devmod
    from bftkv_tpu_torch import topology
    from bftkv_tpu_torch.ops import dispatch
    from bftkv_tpu_torch.protocol.client import Client
    from bftkv_tpu_torch.transport.http import TrHTTP

    # Dispatcher parity with the in-process harness: each worker
    # interpreter batches its own signs/verifies, so the thread-vs-
    # process pair measures interpreter parallelism, not a missing
    # batching plane in the children.
    dev = devmod.resolve(args.device)
    dispatch.install(dispatch.VerifyDispatcher(max_batch=256, device=dev))
    dispatch.install_signer(dispatch.SignDispatcher(max_batch=128, device=dev))
    spec = parse_spec(args.spec)
    graph, crypt, qs = topology.load_home(args.home, device=dev)
    tr = TrHTTP(crypt)
    tr.link_id = graph.name
    client = Client(graph, qs, tr, crypt, device=dev)
    blob = os.urandom(spec.size_max + 1)
    # Warm transport sessions + route caches outside the window (the
    # bench warmup rule: bootstrap envelopes are connection setup, not
    # steady-state op cost).  The warm key is owner-slot-correct for
    # this worker, so TOFU stays single-writer.
    warm = spec.key_bytes(args.worker % spec.owners, 0)
    try:
        client.write(warm, b"warm")
        client.read(warm)
    except Exception:
        pass
    if hasattr(client, "drain_tails"):
        client.drain_tails()
    now = time.time()
    if args.start_at > now:
        time.sleep(args.start_at - now)
    # Full-width slot array: _run_slice indexes the pacer by the
    # GLOBAL worker index, same as the in-process thread pool.
    pacer = Pacer(args.workers)
    hist = LatencyHist()
    kinds: dict = {}
    errors: list = []
    t0 = time.perf_counter()
    done = _run_slice(
        spec, client, args.worker, args.workers, pacer, hist, kinds,
        errors, blob, None, args.max_ops or None,
    )
    elapsed = time.perf_counter() - t0
    if hasattr(client, "drain_tails"):
        client.drain_tails()
    rep = _report(spec, hist, kinds, errors, pacer.backlog(), elapsed,
                  done, 1, "worker")
    rep["lat_total_s"] = round(hist.total, 6)
    with open(args.out, "w") as f:
        json.dump(rep, f)
    tr.stop()


if __name__ == "__main__":
    _worker_main(sys.argv[1:])
