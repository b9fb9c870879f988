"""Runs the control of a cell at the cell's own size and prints its readings.

    python3 -m portbench.control --workload bft10.write_batch --seeds 11,12,13

For each seed: the run's keys and the first call of client 0's traffic
(or, for a mix with a preload, client 0's preloaded records) are written by
the control (:mod:`portbench.reference.control`: the reference in the
system's place, collective signatures one signer short of ``suff``) and
held to the reference as a run's output is.  The control has to come out
not correct on every seed: exit 0 when it does, 1 when a seed passes.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys

from portbench import keys as keysmod
from portbench import run
from portbench.reference import check, control
from portbench.ycsb import Workload, load_mix

__all__ = ["reading"]


def reading(workload: str, seed: int) -> dict:
    _manifest, _cell, config, mix_path = run.load_cell(workload)
    mix = load_mix(mix_path)
    n, n_rw = config["servers"], config["storage_nodes"]
    keys = keysmod.make_keys(seed, n + n_rw + mix.clients, config["key_bits"], algorithm=config["key_algorithm"])
    wl = Workload(mix, seed)
    if mix.recordcount:
        items = [(k, v, 0) for k, v in wl.preload(0)]
    else:
        items = [(op.key, op.value, 0) for op in next(itertools.islice(wl.stream(0), 1))]
    stored = control.records([k.private for k in keys[:n]], [k.private for k in keys[n + n_rw:]], n_rw, items)
    history = {var: (w, [check.Version(v, 0.0, 1.0, True)]) for var, v, w in items}
    uni = check.Universe([k.public for k in keys[:n]], [k.public for k in keys[n + n_rw:]], n_rw)
    numbers = check.check(uni, history, [], stored, sorted(history))
    return {"workload": workload, "seed": seed, "records": len(items),
            "correct": all(v <= 0 for v in numbers.values()), "numbers": numbers}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    outs = []
    for seed in (int(s) for s in args.seeds.split(",")):
        outs.append(reading(args.workload, seed))
        print(json.dumps(outs[-1]), flush=True)
    return 0 if not any(o["correct"] for o in outs) else 1


if __name__ == "__main__":
    sys.exit(main())
