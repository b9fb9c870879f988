"""The benchmark's readers of the idle-state ledger, the flush phases, the
process's cores and the transport's traffic (``portbench/layer_metrics``),
on synthetic windows: each reads its registry deltas, and returns
``None`` where its counters did not move (a program without them); the
full collections' readers read 0 in a window without one."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench.layers import Context, find_reader

LEDGER = {"device.busy.seconds": 1.0, "device.idle.gc.seconds": 10.0,
          "device.idle.flush_host.seconds": 30.0, "device.idle.queued.seconds": 1.0,
          "device.idle.no_work.seconds": 8.0}
TIMERS = {f"{d}.flush.{p}.{k}": v for d in ("dispatch", "signdispatch")
          for p, s in (("encode", 0.6), ("device", 0.02), ("decode", 0.3))
          for k, v in (("count", 10), ("sum", s))}
TRAFFIC = {"transport.rpcs{cmd=batch_write,side=client,transport=loop}": 160,
           "transport.rpcs{cmd=batch_sign,side=client,transport=loop}": 100,
           "transport.rpcs{cmd=batch_write,side=server,transport=loop}": 999,
           "transport.bytes_out{cmd=batch_write,side=client,transport=loop}": 4096 * 60,
           "transport.bytes_in{cmd=batch_write,side=client,transport=loop}": 1024 * 60,
           "transport.bytes_in{cmd=batch_write,side=server,transport=loop}": 10 ** 9}


def _calls(writes: int) -> list:
    """One answered call of ``writes`` acknowledged writes and a failed one."""
    op = SimpleNamespace(kind="insert")
    return [SimpleNamespace(ops=[op] * writes, results=[True] * writes),
            SimpleNamespace(ops=[op], results=[False])]


CASES = {
    "device_busy_events_pct.write": 2.0,
    "idle_gc_pct.write": 20.0,
    "idle_flush_host_pct.write": 60.0,
    "idle_queued_pct.write": 2.0,
    "idle_no_work_pct.write": 16.0,
    "verify_flush_encode_ms.write": 60.0,
    "verify_flush_device_ms.write": 2.0,
    "sign_flush_encode_ms.write": 60.0,
    "sign_flush_device_ms.write": 2.0,
    "sign_flush_decode_ms.write": 30.0,
    "host_cores.write": 4.5,
    "rpcs_per_write.write": 260 / 64,
    "wire_kib_per_write.write": 5 * 60 / 64,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_reader_reads_its_window_and_none_where_nothing_moved(name):
    read = find_reader(name)
    window = {**LEDGER, **TIMERS, **TRAFFIC, "process.cpu_seconds": 4.5 * 50.0}
    assert read(Context(50.0, window, _calls(64), None)) == pytest.approx(CASES[name])
    # A program without these counters (the parent of the change), or a
    # window in which they did not move.
    assert read(Context(50.0, {}, _calls(64), None)) is None
    still = {k: 0 for k in window}
    assert read(Context(50.0, still, _calls(64), None)) is None


def test_the_ledgers_shares_sum_to_a_hundred():
    shares = [find_reader(n)(Context(50.0, dict(LEDGER), [], None))
              for n in CASES if n.startswith(("device_busy", "idle_"))]
    assert len(shares) == 5 and sum(shares) == pytest.approx(100.0)


GC_FULL = {"process.gc.gen2.collections": 4, "process.gc.gen2.seconds": 1.2,
           "process.gc.collections": 400, "process.gc.seconds": 2.0}


@pytest.mark.parametrize("name, value", [("gc_full_collections.write", 4), ("gc_full_ms.write", 1200.0)])
def test_a_full_collection_reader_reads_its_window_and_none_without_the_counter(name, value):
    read = find_reader(name)
    assert read(Context(50.0, {**LEDGER, **GC_FULL}, _calls(64), None)) == pytest.approx(value)
    # A program without the counters by generation (the parent of the change).
    assert read(Context(50.0, {**LEDGER, "process.gc.collections": 400}, _calls(64), None)) is None


def test_a_window_without_a_full_collection_reads_zero_not_a_division_by_zero():
    still = {**GC_FULL, "process.gc.gen2.collections": 0, "process.gc.gen2.seconds": 0.0}
    assert find_reader("gc_full_collections.write")(Context(50.0, still, [], None)) == 0
    assert find_reader("gc_full_ms.write")(Context(50.0, still, [], None)) == 0
