"""A whole run on a tiny CPU cluster, with the look for a card skipped:
sound, it comes out correct; with the program broken underneath, it comes
out not correct, once for each fault the cells can have."""

from __future__ import annotations

import time

import pytest

from portbench import run
from portbench.tests.conftest import READ_MIX, TINY, WRITE_MIX


def _run(mix_file, mix: dict, seed: int) -> dict:
    run.environment()
    wanted = [{"name": "setup_s", "unit": "s"}, {"name": "signed_writes_per_s", "unit": "writes/s"}]
    return run.run_cell({"name": "tiny", "chips": 1}, TINY, mix_file(mix), seed, 2.0, False, wanted,
                        device="cpu", t_start=time.perf_counter(),
                        log=lambda *a, **k: None)


def _flip_last(b: bytes) -> bytes:
    return b[:-1] + bytes([b[-1] ^ 1])


def _flip_value(record: bytes) -> bytes:
    """The record with one byte of its value flipped."""
    at = 8 + int.from_bytes(record[:8], "big") + 8 + 100  # inside the 1 KiB value
    return record[:at] + bytes([record[at] ^ 1]) + record[at + 1:]


def test_sound_runs_are_correct(mix_file):
    for mix, seed in ((WRITE_MIX, 2**33 + 1), (READ_MIX, 2**33 + 2)):
        out = _run(mix_file, mix, seed)
        assert out["correct"], out["checks"]
        assert out["attempted"] > 0 and out["failed"] == 0


def test_a_store_that_keeps_its_state_unchanged(mix_file, monkeypatch):
    from bftkv_tpu_torch.storage.memkv import MemStorage

    monkeypatch.setattr(MemStorage, "write", lambda self, variable, t, value: None)
    out = _run(mix_file, WRITE_MIX, 11)
    assert not out["correct"] and out["checks"]["missing_writes"]["value"] > 0


def test_half_of_each_batch_left_out(mix_file, monkeypatch):
    from bftkv_tpu_torch.protocol.client import Client

    orig = Client._wm_write

    def half(self, items, results, pending, ts, sigs, sss):
        return orig(self, items, results, pending[: len(pending) // 2], ts, sigs, sss)

    monkeypatch.setattr(Client, "_wm_write", half)
    out = _run(mix_file, WRITE_MIX, 12)
    assert not out["correct"] and out["checks"]["missing_writes"]["value"] > 0


@pytest.mark.parametrize("where", ["stored", "read"])
def test_an_answer_altered_where_it_is_produced(mix_file, monkeypatch, where):
    if where == "stored":
        from bftkv_tpu_torch.storage.memkv import MemStorage

        orig = MemStorage.write
        monkeypatch.setattr(MemStorage, "write", lambda self, variable, t, value: orig(self, variable, t, _flip_value(value)))
        mix, number = WRITE_MIX, "missing_writes"
    else:
        from bftkv_tpu_torch.protocol.client import Client

        orig = Client.read
        monkeypatch.setattr(Client, "read", lambda self, variable, proof=None: _flip_last(orig(self, variable, proof)))
        mix, number = READ_MIX, "bad_reads"
    out = _run(mix_file, mix, 13)
    assert not out["correct"] and out["checks"][number]["value"] > 0
