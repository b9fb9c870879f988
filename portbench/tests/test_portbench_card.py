"""The command refuses to run without a card, and on a card a short run of
a cell comes out correct with its metrics."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _run(*args: str, env: dict | None = None, timeout: float = 120) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "portbench.run", *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout, env={**os.environ, **(env or {})})


def test_no_card_no_result():
    out = _run("--workload", "bft10.write_batch", "--seed", "1", "--seconds", "1",
               env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


def test_unknown_cell_is_refused():
    out = _run("--workload", "no.such_cell", "--seed", "1", "--seconds", "1")
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    for trace in ("0", "1"):
        out = _run("--workload", "bft10.write_batch", "--seed", str(2**32 + 3), "--seconds", "5",
                   "--trace", trace, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["attempted"] > 0, line
        assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
        assert list(line)[-1] == "checks"
        want = {"setup_s", "signed_writes_per_s"} if trace == "0" else {"device_idle_pct.write"}
        assert want <= set(line["metrics"])
        if trace == "1":
            assert line["device"]["busy_s"] > 0
