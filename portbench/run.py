"""Runs one cell of the port's benchmark on one H100 and prints its result.

    python3 -m portbench.run --workload bft10.write_batch --seed 7 --seconds 51 --trace 0

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration (``portbench/configs/<config>.json``)
and a traffic mix (``portbench/traffic/<traffic>.json``).  One run makes
the keys and the traffic from ``--seed``, builds the cluster on
``cuda:0``, warms it up, drives the mix for ``--seconds``, holds what the
system stored and answered to the plain reference
(``portbench/reference``), and prints one JSON line: with ``--trace 0``
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics,
read from a ``torch.profiler`` trace of the window and the program's
registry.  Without a card it exits 2 and prints no result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: Modules the process may not hold once the window has closed, by whole
#: top-level name (the port's ``bftkv_tpu_torch`` starts with ``bftkv_tpu``).
FORBIDDEN = ("jax", "jaxlib", "flax", "bftkv_tpu")

#: Acknowledged writes whose certificates the reference verifies, drawn
#: from the seed (every acknowledged write's presence and value is checked).
CERT_SAMPLE = 256
#: Seconds past the window's close that a call in flight may take.
GRACE_S = 60.0
#: Operations each client issues in the warm-up, in one call at the least:
#: the first call makes every node check the client's certificate and
#: drives every kernel and stage of the path.
WARM_OPS = 16
#: Threads of the numeric libraries' pools (OpenMP, OpenBLAS, MKL).  The
#: port's host math is small products between the interpreter's turns; at
#: the libraries' default, a thread per core, 14 idle workers spun on 3.3-3.9
#: of an H100 host's 8 cores beside the interpreter's 1.5, for no more writes.
HOST_MATH_THREADS = "1"


def environment() -> None:
    """The program's switches and every build cache, set before the port
    is imported: tracing off, one card, the verify memo off, the numeric
    libraries on one thread, caches in fixed directories of the checkout."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = HOST_MATH_THREADS
    os.environ["BFTKV_TRACE"] = "off"
    os.environ["BFTKV_SHARD"] = "off"
    # One process holds every node here, and the port's process-wide memo of
    # verified signatures would let a node skip a verify that another node or
    # the signer made; in a deployment each node is its own process and
    # verifies for itself.
    os.environ["BFTKV_VERIFY_CACHE"] = "0"
    cache = os.path.join(HERE, "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def load_cell(name: str, root: str = ROOT) -> tuple[dict, dict, dict, str]:
    """(manifest, cell, configuration, path of the traffic mix) of ``name``
    in the checkout at ``root``."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    return manifest, cell, config, os.path.join(root, "portbench", "traffic", f"{cell['traffic']}.json")


def metrics_of(manifest: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or with
    ``trace`` its per-layer ones."""
    e2e = {m["name"]: m for m in manifest["end_to_end"]}

    def in_cell(m: dict) -> bool:
        if "workloads" in m:
            return cell in m["workloads"]
        return m.get("moves") is None or in_cell(e2e[m["moves"]])

    return [m for m in manifest["per_layer" if trace else "end_to_end"] if in_cell(m)]


def _snapshot() -> dict:
    from bftkv_tpu_torch.metrics import registry

    return {k: v for k, v in registry.snapshot().items() if isinstance(v, (int, float))}


def _host() -> tuple[float, float]:
    """(host clock, this process's CPU seconds)."""
    t = os.times()
    return time.perf_counter(), t.user + t.system


class _GcClock:
    """Counts the interpreter's garbage collections and their seconds while
    it sits in ``gc.callbacks``."""

    def __init__(self):
        self.count, self.seconds, self._t = 0, 0.0, None

    def __call__(self, phase: str, _info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.count += 1
            self.seconds += time.perf_counter() - self._t
            self._t = None


def _window_report(h0: tuple, h1: tuple, gc_clock: _GcClock, threads: int, reg: dict,
                   done: list, t0: float, window_s: float) -> str:
    """One line for a reader of the run's log on what may have moved the
    rate: the cores this process got, the collector's pauses, the threads,
    the window's writes by fifth, and the protocol phases' mean times."""
    wall = max(h1[0] - h0[0], 1e-9)
    fifths = [0] * 5
    for c in done:
        k = min(4, max(0, int(5 * (c.answered - t0) / window_s)))
        fifths[k] += sum(r is True for op, r in zip(c.ops, c.results) if op.kind != "read")

    def mean_ms(name: str) -> str:
        n = reg.get(f"{name}.count", 0)
        return f"{1e3 * reg.get(f'{name}.sum', 0.0) / n:.1f}" if n else "-"

    return (f"portbench: window host: this process {(h1[1] - h0[1]) / wall:.2f} cores of "
            f"{os.cpu_count()}; gc {gc_clock.count} collections {gc_clock.seconds:.3f} s; {threads} threads; "
            f"acknowledged writes by fifth of the window {fifths}; ms sign phase "
            f"{mean_ms('client.write_many.phase_sign')}, write phase {mean_ms('client.write_many.phase_write')}, "
            f"batch_write {mean_ms('server.batch_write.handler')}; flushes verify "
            f"{reg.get('dispatch.flushes', 0):.0f}, sign {reg.get('signdispatch.flushes', 0):.0f}")


def _is_error(result) -> bool:
    """Whether a read's result is the error it failed with."""
    return isinstance(result, BaseException) or (isinstance(result, type) and issubclass(result, BaseException))


def _history(calls: list, preload: dict) -> tuple[dict, list, int]:
    """What the reference is given: every variable's writes in issue order,
    the reads that answered, and the operations never answered."""
    from portbench.reference.check import Read, Version

    history = {var: (owner, [Version(value, t, t, True)]) for var, (owner, value, t) in preload.items()}
    reads, unanswered = [], 0
    for call in sorted(calls, key=lambda c: c.issued):
        if call.answered is None:
            unanswered += len(call.ops)
        for k, op in enumerate(call.ops):
            res = call.results[k] if call.answered is not None else None
            if op.kind == "read":
                if call.answered is not None and not _is_error(res):
                    reads.append(Read(op.key, call.issued, call.answered, res))
                continue
            entry = history.setdefault(op.key, (call.client, []))
            entry[1].append(Version(op.value, call.issued, call.answered, res is True))
    return history, reads, unanswered


def run_cell(cell: dict, config: dict, mix_path: str, seed: int, seconds: float, trace: bool,
             wanted: list[dict], device="cuda:0", *, t_start: float = _T0,
             readers: str | None = None, log=print) -> dict:
    """One run of ``cell``; returns the result line's object.  ``readers``:
    the directory of the per-layer readers (default the harness's)."""
    import torch

    from portbench import cluster as clustermod
    from portbench import keys as keysmod
    from portbench.driver import Driver
    from portbench.layers import Context, find_reader
    from portbench.reference import check as ref
    from portbench.ycsb import Op, Workload, load_mix

    mix = load_mix(mix_path)
    n, n_rw = config["servers"], config["storage_nodes"]
    keys = keysmod.make_keys(seed, n + n_rw + mix.clients, config["key_bits"],
                             algorithm=config["key_algorithm"])
    t_keys = time.perf_counter()
    cl = clustermod.build(config, mix.clients, keys, device)
    t_cluster = time.perf_counter()
    try:
        wl = Workload(mix, seed)
        preload: dict = {}
        if mix.recordcount:
            pre = Driver(cl.clients, [iter([[Op("insert", k, v) for k, v in wl.preload(c)]])
                                      for c in range(mix.clients)])
            pre.warm(1, timeout=300.0)
            for calls in pre.calls:
                for call in calls:
                    if not all(r is True for r in call.results):
                        raise RuntimeError("the preload's write_many failed")
                    for op in call.ops:
                        preload[op.key] = (call.client, op.value, call.answered)
        driver = Driver(cl.clients, [wl.stream(c) for c in range(mix.clients)])
        driver.warm(-(-WARM_OPS // mix.batch), timeout=300.0)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        log(f"portbench: set-up keys {t_keys - t_start:.1f} s, cluster {t_cluster - t_keys:.1f} s, "
            f"preload and warm-up {time.perf_counter() - t_cluster:.1f} s; fan-out {cl.fanout}",
            file=sys.stderr)

        prof = hooks = None
        if trace:
            from portbench.devtrace import Profiler
            from portbench.hooks import KernelHooks

            prof, hooks = Profiler(), KernelHooks()
            hooks.install()
        snaps, hosts, gc_clock = [], [], _GcClock()

        def on_start():
            if prof is not None:
                prof.start()
            snaps.append(_snapshot())
            hosts.append(_host())
            gc.callbacks.append(gc_clock)

        setup_s = time.perf_counter() - t_start
        t0, end, threads = driver.window(seconds, on_start)
        hosts.append(_host())
        gc.callbacks.remove(gc_clock)
        n_threads = threading.active_count()
        snaps.append(_snapshot())
        if trace:
            dtrace = prof.stop()
            launches, unmodelled = list(hooks.launches), dict(hooks.unmodelled)
            hooks.remove()
        Driver.join(threads, end + GRACE_S)
        cl.drain()
        peak = torch.cuda.max_memory_reserved() if torch.cuda.is_available() else 0

        calls = [c for log_ in driver.calls for c in log_]
        # The window: from the release until the last call issued before the
        # deadline has answered; every operation of those calls counts.
        in_window = [c for c in calls if t0 <= c.issued < end]
        done = [c for c in in_window if c.answered is not None]
        span_s = max([end] + [c.answered for c in done]) - t0
        acked_writes = sum(r is True for c in done for op, r in zip(c.ops, c.results) if op.kind != "read")
        answered_reads = sum(not _is_error(r) for c in done for op, r in zip(c.ops, c.results)
                             if op.kind == "read")
        attempted = sum(len(c.ops) for c in in_window)
        failed = sum(1 for c in in_window for k, op in enumerate(c.ops)
                     if c.answered is None or (c.results[k] is not True if op.kind != "read"
                                               else _is_error(c.results[k])))
        reg = {k: v - snaps[0].get(k, 0) for k, v in snaps[1].items()}
        log(_window_report(hosts[0], hosts[1], gc_clock, n_threads, reg, done, t0, end - t0), file=sys.stderr)

        # The reference, once the window has closed.
        t_ref = time.perf_counter()
        history, reads, unanswered = _history(calls, preload)
        stored = {var: cl.stored(var) for var in history}
        rng = random.Random(f"{seed}/sample")
        acked = sorted(v for v, (_o, vs) in history.items() if any(x.acked for x in vs))
        sample = rng.sample(acked, min(CERT_SAMPLE, len(acked)))
        uni = ref.Universe(servers=[k.public for k in keys[:n]],
                           clients=[k.public for k in keys[n + n_rw:]], n_storage=n_rw)
        numbers = ref.check(uni, history, reads, stored, sample)
        numbers["unanswered"] = unanswered
        log(f"portbench: reference over {len(history)} variables, {len(reads)} reads, "
            f"{len(sample)} certificates in {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    finally:
        cl.stop()

    window_s = end - t0
    if trace:
        ctx = Context(window_s=window_s, registry=reg,
                      calls=done, trace=dtrace, launches=launches, unmodelled=unmodelled)
        values = {m["name"]: find_reader(m["name"], readers)(ctx) for m in wanted}
        log(f"portbench: K1 launches {sum(x.kernel == 'k1' for x in launches)}, "
            f"K2 {sum(x.kernel == 'k2' for x in launches)}, K5 {sum(x.kernel == 'k5' for x in launches)}, "
            f"unmodelled {unmodelled}", file=sys.stderr)
        counters = {k: v for k, v in sorted(ctx.registry.items())
                    if k.split(".")[0] in ("dispatch", "signdispatch", "verify", "sign")
                    and not k.endswith((".p50", ".p99")) and ".bucket" not in k and v}
        log(f"portbench: registry over the window {json.dumps(counters)}", file=sys.stderr)
    else:
        e2e = {"setup_s": setup_s, "signed_writes_per_s": acked_writes / span_s,
               "ops_per_s": (acked_writes + answered_reads) / span_s}
        log(f"portbench: {acked_writes} writes acknowledged, {answered_reads} reads answered in "
            f"{span_s:.3f} s ({span_s - window_s:.3f} s past the deadline)", file=sys.stderr)
        values = {m["name"]: e2e[m["name"]] for m in wanted}
    out = {
        "correct": all(v <= 0 for v in numbers.values()),
        "attempted": attempted,
        "failed": failed,
        "metrics": {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                    for m in wanted if values[m["name"]] is not None},
        "device": {"platform": "gpu" if str(device).startswith("cuda") else "cpu",
                   "kind": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
                   "count": int(cell.get("chips", 1)),
                   "memory_peak_bytes": int(peak)},
    }
    if trace:
        out["device"]["busy_s"] = dtrace.busy_s()
        out["device"]["window_s"] = window_s
        out["breakdown"] = {"device_ops": dtrace.top_ops(10), "idle_gaps": dtrace.idle_gaps(10)}
    out["checks"] = {k: {"value": v, "limit": 0} for k, v in numbers.items()}
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest, cell, config, mix_path = load_cell(args.workload)
    environment()
    import torch

    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, config, mix_path, args.seed, args.seconds, bool(args.trace),
                   metrics_of(manifest, cell["name"], bool(args.trace)))
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"portbench: the process loaded {loaded}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"portbench: check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
