"""``python -m bftkv_tpu_torch.autopilot`` — standalone fleet watcher
(counterpart of ``bftkv_tpu/autopilot/__main__.py``).

Consumes a fleet collector's ``/fleet`` document (cmd.fleet /
``run_cluster --fleet``) on an interval and prints the decisions the
autopilot would take — per-shard f-budget retirement triggers and
SLO-load split suggestions — as JSON lines.  Against a multi-process
fleet this mode is advisory (``--dry-run`` is the default and, for
now, the only mode): executing a migration needs the in-process
executor (:class:`bftkv_tpu_torch.autopilot.Autopilot` — the chaos
nemesis and ``tests/test_torch_autopilot.py`` run it end to end), and
the daemon-fleet execute path ships the same signed
``RouteTable.serialize()`` bytes when it lands.

    python -m bftkv_tpu_torch.autopilot --fleet-url http://127.0.0.1:7999/fleet

The watcher is host code: it imports no torch and takes no device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request

from bftkv_tpu_torch.autopilot.daemon import autopilot_enabled
from bftkv_tpu_torch.autopilot.plan import HOT_SKEW, MIN_LOAD

__all__ = ["main", "advise"]


def advise(
    doc: dict, hot_skew: float = HOT_SKEW, min_load: int = MIN_LOAD
) -> list[dict]:
    """Advisory decisions from one /fleet health document: retire any
    shard whose f-budget is spent; split the hottest shard when its
    SLO write count exceeds ``hot_skew`` × the fair share — but only
    past ``min_load`` total writes (the same twitchiness floor
    ``plan.decide`` applies: a fleet that has seen three writes has no
    meaningful skew)."""
    out: list[dict] = []
    shards = doc.get("shards", {})
    for sh, sd in sorted(shards.items()):
        fb = sd.get("f_budget") or {}
        if fb.get("remaining", 1) <= 0 and len(shards) > 1:
            out.append({
                "kind": "retire",
                "shard": int(sh),
                "reason": (
                    f"f-budget {fb.get('remaining')}/{fb.get('f')} "
                    f"(down: {','.join(fb.get('down', []))})"
                ),
            })
    loads = {
        int(sh): (sd.get("slo", {}).get("write") or {}).get("count", 0)
        for sh, sd in shards.items()
    }
    total = sum(loads.values())
    if total >= min_load and len(loads) > 1:
        hot = max(loads, key=lambda k: loads[k])
        fair = total / len(loads)
        if loads[hot] > hot_skew * fair:
            out.append({
                "kind": "split",
                "shard": hot,
                "reason": (
                    f"shard {hot} at {loads[hot]}/{total} writes "
                    f"(fair share {fair:.0f})"
                ),
            })
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="topology autopilot watcher (advisory, over /fleet)"
    )
    ap.add_argument("--fleet-url", required=True,
                    help="the collector's /fleet JSON endpoint")
    ap.add_argument("--interval", type=float, default=5.0)
    ap.add_argument("--hot-skew", type=float, default=HOT_SKEW,
                    help="split when the hottest shard exceeds this "
                         "multiple of the fair load share")
    ap.add_argument("--once", action="store_true",
                    help="one scrape, print advice, exit 0/3 "
                         "(3 = advice pending)")
    args = ap.parse_args(argv)

    if not autopilot_enabled():
        print(json.dumps({"autopilot": "disabled (BFTKV_AUTOPILOT=off)"}))
        return 0

    def fetch() -> dict:
        with urllib.request.urlopen(args.fleet_url, timeout=10) as r:
            return json.loads(r.read())

    if args.once:
        advice = advise(fetch(), args.hot_skew)
        print(json.dumps({"ts": time.time(), "advice": advice}))
        return 3 if advice else 0

    try:
        while True:
            try:
                advice = advise(fetch(), args.hot_skew)
                print(
                    json.dumps({"ts": time.time(), "advice": advice}),
                    flush=True,
                )
            except Exception as e:
                print(
                    json.dumps({"ts": time.time(), "error": str(e)}),
                    flush=True,
                )
            time.sleep(args.interval)
    except KeyboardInterrupt:
        # Ctrl-C mostly lands in the sleep — exit clean either way.
        return 0


if __name__ == "__main__":
    sys.exit(main())
