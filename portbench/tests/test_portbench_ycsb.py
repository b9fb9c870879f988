"""The one traffic generator: repeatable from the seed, YCSB's shares,
ownership and batches."""

from __future__ import annotations

import itertools
import json
from pathlib import Path

import pytest

from portbench.ycsb import Mix, Workload, fnvhash64, load_mix

TRAFFIC = Path(__file__).resolve().parent.parent / "traffic"

#: YCSB's workload B (workloads/workloadb), as a later cell's mix would state it.
YCSB_B = {"clients": 16, "batch": 1, "recordcount": 1000, "fieldlength": 1024, "readproportion": 0.95,
          "updateproportion": 0.05, "insertproportion": 0.0, "requestdistribution": "zipfian",
          "zipfian_constant": 0.99}


def _ops(wl: Workload, client: int, calls: int) -> list:
    return [op for call in itertools.islice(wl.stream(client), calls) for op in call]


def test_a_seed_repeats_and_another_differs(mix_file):
    mix = load_mix(mix_file(YCSB_B))
    a, b, c = Workload(mix, 2**31 + 5), Workload(mix, 2**31 + 5), Workload(mix, 2**31 + 6)
    assert _ops(a, 3, 200) == _ops(b, 3, 200)
    assert _ops(a, 3, 200) != _ops(c, 3, 200)
    assert a.preload(3) == b.preload(3) != c.preload(3)


def test_ycsb_b_shares_and_ownership(mix_file):
    mix = load_mix(mix_file(YCSB_B))
    wl = Workload(mix, 77)
    ops = [op for c in range(mix.clients) for op in _ops(wl, c, 2000)]
    reads = sum(op.kind == "read" for op in ops)
    assert reads / len(ops) == pytest.approx(0.95, abs=0.01)
    assert all(op.kind in ("read", "update") for op in ops)
    records = {wl.key(i) for i in range(mix.recordcount)}
    assert {op.key for op in ops} <= records
    for c in range(mix.clients):
        own = {k for k, _v in wl.preload(c)}
        assert all(op.key in own for op in _ops(wl, c, 500) if op.kind == "update")
        assert all(len(op.value) == mix.fieldlength for op in _ops(wl, c, 500) if op.kind == "update")


def test_zipfian_draws_are_skewed(mix_file):
    mix = load_mix(mix_file(YCSB_B))
    wl = Workload(mix, 5)
    counts: dict = {}
    for op in _ops(wl, 0, 20000):
        counts[op.key] = counts.get(op.key, 0) + 1
    top = sorted(counts.values(), reverse=True)
    assert top[0] > 20 * (20000 / mix.recordcount)


def test_write_batch_inserts_fresh_distinct_keys():
    mix = load_mix(str(TRAFFIC / "write_batch.json"))
    wl = Workload(mix, 9)
    calls = [call for c in range(mix.clients) for call in itertools.islice(wl.stream(c), 20)]
    assert all(len(call) == mix.batch and all(op.kind == "insert" for op in call) for call in calls)
    keys = [op.key for call in calls for op in call]
    assert len(keys) == len(set(keys))


def test_fnvhash64_is_ycsbs():
    # FNV-1 over 8 little-endian bytes, then Java's Math.abs of the long.
    assert fnvhash64(0) == 6284781860667377211  # YCSB's first key, user6284781860667377211
    assert all(0 <= fnvhash64(i) < 1 << 63 for i in range(1000))


def test_bad_mix_is_refused(tmp_path):
    p = tmp_path / "m.json"
    p.write_text(json.dumps({**Mix(1, 1, 10, 8, 0.5, 0.4, 0.0).__dict__}))
    with pytest.raises(ValueError):
        load_mix(str(p))
