"""``fleet`` — the fleet health CLI (collector front end).

Counterpart of ``bftkv_tpu/cmd/fleet.py``.

One-shot report against a running fleet's daemon APIs::

    python -m bftkv_tpu_torch.cmd.fleet --api-base 7001 --count 8

or watch continuously, or serve the collector's ``/fleet`` endpoint
(JSON + Prometheus) for dashboards::

    python -m bftkv_tpu_torch.cmd.fleet --api-base 7001 --count 8 \
        --watch --interval 2 --listen 127.0.0.1:7999

``run_cluster --fleet PORT`` boots exactly this alongside the fleet.

Exit codes (one-shot): 0 healthy, 1 some shard's f-budget is exhausted
(``remaining < 0`` — more clique members dark than the b-masking bound
tolerates), 2 nothing scrapeable.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from bftkv_tpu_torch.obs import FleetCollector, HTTPSource

__all__ = ["main", "render", "render_budget", "render_capacity"]


def render_capacity(doc: dict) -> str:
    """The ``--capacity`` table: per member, each exposed resource's
    USE row (utilization / saturation / errors), then the ranked
    bottleneck verdict — the "what do we fix next to go faster"
    answer (DESIGN.md §20)."""
    cap = doc.get("capacity") or {}
    members = cap.get("members") or {}
    lines: list[str] = []
    for member, rows in sorted(members.items()):
        if not rows:
            continue
        lines.append(f"capacity · {member}:")
        for res, row in sorted(
            rows.items(), key=lambda kv: -kv[1]["saturation"]
        ):
            bar = "#" * max(int(row["saturation"] * 24), 0)
            extras = []
            for k in ("items_per_launch", "mbps", "runnable", "backlog",
                      "batch_fill", "fsync_per_s"):
                v = row.get(k)
                if v not in (None, 0, 0.0):
                    extras.append(f"{k}={v:g}")
            disps = row.get("dispatchers") or {}
            for dname, d in sorted(disps.items()):
                occ = d.get("device_occupancy") or {}
                for w, o in sorted(occ.items()):
                    extras.append(f"{dname}[{w}]={o:.2f}")
                if d.get("items_per_launch"):
                    extras.append(
                        f"{dname}/launch={d['items_per_launch']:g}"
                    )
            lines.append(
                f"  {res:<12} util {row['utilization']:>5.0%}  "
                f"sat {row['saturation']:>5.0%}  "
                f"err {row['errors']:g}  {bar}"
                + ("  (" + ", ".join(extras) + ")" if extras else "")
            )
    verdict = cap.get("verdict") or {}
    lines.append(f"verdict: {verdict.get('summary', 'no capacity data')}")
    for r in (verdict.get("ranked") or [])[:5]:
        lines.append(
            f"  {r['score']:.3f}  {r['resource']:<12} on {r['member']} "
            f"(sat {r['saturation']:.2f} x weight {r['phase_weight']:.2f})"
        )
    return "\n".join(lines)


def render_budget(doc: dict) -> str:
    """The ``--budget`` table: per (op, shard), each phase's exclusive
    share of the wall clock plus the p99 exemplar's breakdown — the
    "where did the p99 go" answer (DESIGN.md §18)."""
    lines: list[str] = []
    for op in ("write", "read"):
        budget = doc.get(f"{op}_budget_by_phase") or {}
        for sh, b in sorted(budget.items(), key=lambda kv: str(kv[0])):
            lines.append(
                f"{op} budget · shard {sh}: {b['count']} traces, "
                f"total {b['root_sum_s']:g}s, "
                f"root p99≤{b['root_p99_le_s']:g}s"
            )
            phases = sorted(
                b.get("phases", {}).items(),
                key=lambda kv: -kv[1]["sum_s"],
            )
            for phase, pd in phases:
                if pd["sum_s"] <= 0:
                    continue
                bar = "#" * max(int(pd["share"] * 40), 1)
                lines.append(
                    f"  {phase:<9} {pd['share']:>6.1%}  "
                    f"{pd['sum_s']:>10.4f}s  {bar}"
                )
            ex = b.get("p99_exemplar")
            if ex:
                parts = ", ".join(
                    f"{p}={v:g}s"
                    for p, v in sorted(
                        ex["phases"].items(), key=lambda kv: -kv[1]
                    )
                )
                lines.append(
                    f"  p99 exemplar: trace={ex['trace_id']} "
                    f"{ex['root_s']:g}s → {parts}"
                )
    if not lines:
        lines.append(
            "no attributed traces yet (budgets need two scrapes: "
            "roots attribute one scrape after they appear)"
        )
    return "\n".join(lines)


def render(doc: dict) -> str:
    """The one-shot human report for one health document."""
    fl = doc["fleet"]
    tr = doc["traces"]
    lines = [
        f"fleet: {fl['up']}/{fl['daemons']} daemons up · "
        f"{len(doc['shards'])} shard(s) · "
        f"{tr['traces']} traces ({tr['stitched']} stitched) · "
        f"{len(doc['anomalies'])} anomalies"
    ]
    if fl.get("unseated"):
        lines.append(
            "UNSEATED (never answered /info — shard budgets "
            f"indeterminate): {', '.join(fl['unseated'])}"
        )
    repochs = fl.get("route_epochs") or {}
    if isinstance(repochs.get("max"), int) and repochs["max"] > 0:
        lines.append(
            f"route table: epoch {repochs['max']}"
            + (
                f" (SKEWED — some members still at {repochs['min']})"
                if repochs.get("skewed")
                else ""
            )
        )
    ap = doc.get("autopilot")
    if ap:
        last = ap.get("last") or {}
        lines.append(
            "autopilot: "
            + ("on" if ap.get("enabled") else "OFF (BFTKV_AUTOPILOT)")
            + f" · epoch {ap.get('epoch')}"
            + f" · migrations {ap.get('migrations', 0)}"
            + (
                f" · last {last['kind']}: shard {last.get('shard')} → "
                f"{last.get('targets')} ({last.get('buckets')} buckets, "
                f"{'ok' if last.get('ok') else 'in flight/blocked'})"
                if last.get("kind")
                else ""
            )
        )
        if ap.get("retired"):
            lines.append(f"  retired cliques: {ap['retired']}")
    drops = fl.get("trace_drops") or {}
    if drops.get("ring") or drops.get("slow"):
        lines.append(
            f"TRACE DROPS: ring={drops.get('ring', 0)} "
            f"slow={drops.get('slow', 0)} — attribution under-samples; "
            "scrape more often or raise the rings"
        )
    for sh, sd in sorted(doc["shards"].items()):
        fb = sd["f_budget"]
        slo = sd.get("slo", {})
        w = slo.get("write")
        slo_txt = (
            f" · write p50≤{w['p50_le_s']:g}s p99≤{w['p99_le_s']:g}s "
            f"(n={w['count']})"
            if w
            else ""
        )
        lines.append(
            f"shard {sh}: n={sd['n']} f={sd['f']} "
            f"2f+1={sd['threshold']} · "
            f"budget {fb['remaining']}/{fb['f']}"
            + (f" DOWN={','.join(fb['down'])}" if fb["down"] else "")
            + (
                f" storage-down={','.join(fb['storage_down'])}"
                if fb["storage_down"]
                else ""
            )
            + slo_txt
        )
        for mem in sd["members"]:
            mark = "·" if mem["status"] == "up" else "✗"
            ep = mem.get("epoch")
            lines.append(
                f"  {mark} {mem['name']} [{mem['role'] or '?'}] "
                f"{mem['status']}"
                + (f" e{ep}" if isinstance(ep, int) and ep > 0 else "")
            )
        for ex in sd.get("exemplars", [])[-3:]:
            lines.append(
                f"  slow: {ex['root']} {ex['duration']}s "
                f"trace={ex['trace_id']}"
                + (f" peer={ex['peer']}" if "peer" in ex else "")
            )
    regs = doc.get("regions") or {}
    if regs:
        rb = regs["f_budget"]
        lines.append(
            f"regions: {regs['n']} · region budget "
            f"{rb['remaining']}/{rb['f']}"
            + (f" DARK={','.join(rb['dark'])}" if rb["dark"] else "")
        )
        for rname, row in sorted(regs["rows"].items()):
            mark = "✗" if row["dark"] else "·"
            lines.append(
                f"  {mark} {rname}: {row['up']}/{row['members']} up"
                + (f" down={','.join(row['down'])}" if row["down"] else "")
                + (
                    f" gw={','.join(row['gateways'])}"
                    if row["gateways"]
                    else ""
                )
            )
    for name, g in sorted((doc.get("gateways") or {}).items()):
        mark = "·" if g["status"] == "up" else "✗"
        hits, misses = g.get("hits", 0), g.get("misses", 0)
        rate = hits / (hits + misses) if hits + misses else 0.0
        lines.append(
            f"  {mark} {name} [gateway] {g['status']} · "
            f"cache {g.get('entries', 0)} entries, "
            f"hit rate {rate:.0%} · shed {g.get('shed', 0)} · "
            f"verify_fail {g.get('verify_fail', 0)}"
            + (
                f" · lease serves {g['lease_served']}"
                f"{' (live)' if g.get('lease_live') else ''}"
                if g.get("lease_served")
                else ""
            )
        )
    for name, s in sorted((doc.get("sidecars") or {}).items()):
        mark = "·" if s["status"] == "up" else "✗"
        q = s.get("queue") or {}
        batch = (s.get("batch") or {}).get("sign") or {}
        occ = batch.get("occupancy_per_launch")
        lines.append(
            f"  {mark} {name} [sidecar] {s['status']} · "
            f"queue {q.get('inflight', 0)}+{q.get('waiting', 0)} "
            f"shed {q.get('shed', 0)}"
            + (f" · sign occupancy {occ:g}/launch" if occ else "")
        )
    for a in doc["anomalies"][-8:]:
        lines.append(
            f"anomaly #{a['seq']} {a['kind']} src={a['source']} "
            f"shard={a['shard']} {a['detail']} x{a['count']}"
        )
    return "\n".join(lines)


def _watch_line(doc: dict) -> str:
    budgets = " ".join(
        f"s{sh}:{sd['f_budget']['remaining']}/{sd['f_budget']['f']}"
        for sh, sd in sorted(doc["shards"].items())
    )
    return (
        f"[{time.strftime('%H:%M:%S')}] up={doc['fleet']['up']}"
        f"/{doc['fleet']['daemons']} budget {budgets} "
        f"traces={doc['traces']['traces']}"
        f"({doc['traces']['stitched']} stitched) "
        f"anomalies={len(doc['anomalies'])}"
    )


def _exit_code(doc: dict) -> int:
    if doc["fleet"]["up"] == 0:
        return 2
    if any(
        sd["f_budget"]["remaining"] < 0 for sd in doc["shards"].values()
    ):
        return 1
    if doc["fleet"].get("unseated"):
        # A member whose seat was never learned: the per-shard budgets
        # cannot be trusted while it is unaccounted for.
        return 1
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="fleet health collector (bftkv_tpu_torch.obs)"
    )
    ap.add_argument("--targets", default="",
                    help="comma-separated daemon API addresses "
                         "(host:port,host:port,...)")
    ap.add_argument("--api-base", type=int, default=0,
                    help="first daemon API port (run_cluster --api-base); "
                         "use with --count")
    ap.add_argument("--count", type=int, default=0,
                    help="how many sequential API ports from --api-base")
    ap.add_argument("--api-host", default="127.0.0.1")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="scrape interval seconds (watch/listen modes)")
    ap.add_argument("--watch", action="store_true",
                    help="keep scraping, one status line per interval")
    ap.add_argument("--listen", default="",
                    help="serve /fleet (JSON + Prometheus) on host:port; "
                         "implies background scraping")
    ap.add_argument("--json", action="store_true",
                    help="one-shot: print the full health document as JSON")
    ap.add_argument("--scrapes", type=int, default=1,
                    help="one-shot: scrape this many times (interval apart) "
                         "before reporting — 2+ arms counter-delta anomalies")
    ap.add_argument("--budget", action="store_true",
                    help="one-shot: per-shard critical-path budget table "
                         "(phase shares + p99 exemplar; implies 2 scrapes "
                         "— attribution defers one scrape for stitching)")
    ap.add_argument("--capacity", action="store_true",
                    help="one-shot: USE-method capacity table + bottleneck "
                         "verdict (implies 2 scrapes — saturation judges "
                         "per-scrape deltas)")
    ap.add_argument("--bundle", default=None, metavar="DIR", nargs="?",
                    const="",
                    help="one-shot: write a flight-recorder bundle of "
                         "everything just scraped into DIR (default "
                         "BFTKV_RECORDER_DIR / <tmp>/bftkv-blackbox) and "
                         "print its path")
    ap.add_argument("--recorder", default="", metavar="DIR",
                    help="watch/listen: attach the flight recorder — every "
                         "anomaly snapshots a rate-limited, size-capped "
                         "black-box bundle under DIR, and POST "
                         "/fleet/bundle serves demand snapshots")
    ap.add_argument("--profile", type=float, default=0.0, metavar="SECONDS",
                    help="one-shot: also pull an N-second collapsed-stack "
                         "profile from every HTTP target (/profile)")
    args = ap.parse_args(argv)

    targets = [t for t in args.targets.split(",") if t.strip()]
    if args.api_base and args.count:
        targets += [
            f"{args.api_host}:{args.api_base + i}" for i in range(args.count)
        ]
    if not targets:
        print("fleet: no targets (--targets or --api-base/--count)",
              file=sys.stderr)
        return 2

    sources = [HTTPSource(t) for t in targets]
    collector = FleetCollector(sources, interval=args.interval)

    if args.listen or args.watch:
        if args.recorder:
            from bftkv_tpu_torch.obs.recorder import FlightRecorder

            rec = FlightRecorder(args.recorder).add_to(collector)
            print(f"fleet: flight recorder @ {rec.dir}", flush=True)
        collector.start(args.interval)
        httpd = None
        if args.listen:
            from bftkv_tpu_torch.obs.http import serve_fleet

            httpd = serve_fleet(collector, args.listen)
            print(f"fleet: /fleet @ {args.listen}", flush=True)
        try:
            while True:
                time.sleep(args.interval)
                if args.watch:
                    print(_watch_line(collector.health()), flush=True)
        except KeyboardInterrupt:
            pass
        finally:
            collector.stop()
            if httpd is not None:
                httpd.shutdown()
        return 0

    doc = None
    scrapes = max(args.scrapes, 2 if args.budget or args.capacity else 1)
    for i in range(scrapes):
        if i:
            time.sleep(args.interval)
        doc = collector.scrape_once()
    profiles = None
    if args.profile > 0:
        # Each /profile request BLOCKS for the window; the windows are
        # independent daemons' — capture them concurrently so the
        # one-shot costs ~one window, not members x window.
        import threading

        results = [""] * len(sources)

        def pull(i: int, src) -> None:
            try:
                results[i] = src.profile(args.profile)
            except Exception as e:
                results[i] = f"# profile failed: {e}\n"

        threads = [
            threading.Thread(target=pull, args=(i, s), daemon=True)
            for i, s in enumerate(sources)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        profiles = {
            src.name or src.base: text
            for src, text in zip(sources, results)
        }
    bundle_path = None
    if args.bundle is not None:
        from bftkv_tpu_torch.obs.recorder import FlightRecorder

        rec = FlightRecorder(args.bundle or None, collector=collector)
        bundle_path = rec.snapshot(reason="demand")
    if args.json:
        # One parseable document on stdout, always: --profile/--bundle
        # results ride INSIDE it rather than trailing it (which would
        # break every `--json | jq .` consumer with Extra data).
        doc = dict(doc)
        if profiles is not None:
            doc["profiles"] = profiles
        if bundle_path is not None:
            doc["bundle"] = bundle_path
        print(json.dumps(doc, indent=1, sort_keys=True, default=str))
    else:
        print(render(doc))
        if args.budget:
            print(render_budget(doc))
        if args.capacity:
            print(render_capacity(doc))
        for name, text in (profiles or {}).items():
            print(f"--- profile {name} ---")
            print(text, end="")
        if bundle_path is not None:
            print(f"bundle: {bundle_path}")
    return _exit_code(doc)


if __name__ == "__main__":
    sys.exit(main())
