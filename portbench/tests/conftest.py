"""Shared fixtures of the harness's tests: a tiny deployment on the CPU.

The port's tests use 1024-bit keys on the CPU as well; the cells' sizes run
only on the card (``python3 -m portbench.run``)."""

from __future__ import annotations

import json

import pytest

TINY = {"servers": 4, "storage_nodes": 4, "key_algorithm": "rsa", "key_bits": 1024, "storage": "mem",
        "transport": "loopback", "dispatch_max_batch": 4096}

WRITE_MIX = {"clients": 2, "batch": 8, "recordcount": 0, "fieldlength": 1024, "readproportion": 0.0,
             "updateproportion": 0.0, "insertproportion": 1.0, "requestdistribution": "uniform"}

READ_MIX = {"clients": 4, "batch": 1, "recordcount": 40, "fieldlength": 1024, "readproportion": 0.8,
            "updateproportion": 0.2, "insertproportion": 0.0, "requestdistribution": "zipfian",
            "zipfian_constant": 0.99}


@pytest.fixture
def mix_file(tmp_path):
    def make(mix: dict) -> str:
        path = tmp_path / "mix.json"
        path.write_text(json.dumps(mix))
        return str(path)
    return make


@pytest.fixture
def card():
    """Skips a test marked ``cuda`` where this machine has no card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"
