"""The harness is driven by data: a new mix and a new per-layer metric are
new files and manifest entries, found by name, with no edit to any file
that is there; and the manifest keeps to its limits."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

from portbench import run
from portbench.layers import Context, find_reader
from portbench.tests.conftest import READ_MIX, TINY

ROOT = Path(__file__).resolve().parents[2]


def _checkout(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench", ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_a_new_mix_and_reader_are_found_by_name(tmp_path):
    root = _checkout(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "portbench" / "traffic" / "dummy_mix.json").write_text(json.dumps(READ_MIX))
    (root / "portbench" / "layer_metrics" / "dummy_calls.py").write_text(
        "def read(ctx):\n    return float(len(ctx.calls))\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "bft10.dummy", "config": "bft10_rsa2048", "traffic": "dummy_mix",
                                  "chips": 1, "why": "a test cell"})
    rate = next(m for m in manifest["end_to_end"] if m["name"] == "signed_writes_per_s")
    rate["workloads"].append("bft10.dummy")
    manifest["per_layer"].append({"name": "dummy_calls.x", "unit": "calls", "better": "higher",
                                  "source": "host_clock", "layer": "client API", "moves": "signed_writes_per_s",
                                  "workloads": ["bft10.dummy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    assert all(p.read_bytes() == b for p, b in before.items() if p.name != "BENCHMARK.json")

    _m, cell, config, mix_path = run.load_cell("bft10.dummy", str(root))
    assert config["servers"] == 10 and mix_path.endswith("dummy_mix.json")
    wanted = run.metrics_of(manifest, "bft10.dummy", True)
    assert [m["name"] for m in wanted] == ["dummy_calls.x"]
    reader = find_reader("dummy_calls.x", str(root / "portbench" / "layer_metrics"))
    assert reader(Context(1.0, {}, [1, 2, 3], None)) == 3.0

    run.environment()
    out = run.run_cell(cell, TINY, mix_path, 5, 1.0, True, wanted, device="cpu", t_start=time.perf_counter(),
                       readers=str(root / "portbench" / "layer_metrics"),
                       log=lambda *a, **k: None)
    assert out["correct"] and out["metrics"]["dummy_calls.x"]["value"] > 0


def test_every_manifest_metric_has_a_reader_and_a_cell():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert find_reader(m["name"]) is not None
        assert set(m["workloads"]) <= cells and set(m["workloads"]) <= set(e2e[m["moves"]]["workloads"])
    for w in manifest["workloads"]:
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").exists()
        assert w["chips"] == 1
        reported = [m for m in manifest["end_to_end"] if w["name"] in m.get("workloads", cells)]
        assert {"setup_s"} < {m["name"] for m in reported}
        assert any(w["name"] in m["workloads"] for m in manifest["per_layer"])
    for c in manifest["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
