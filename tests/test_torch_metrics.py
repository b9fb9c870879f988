"""The port's metrics registry (``bftkv_tpu_torch/metrics.py``) against the
reference's (``bftkv_tpu/metrics.py``): the same calls give the same
Prometheus text byte for byte (labels, escaping, the ``+Inf`` bucket, an
empty registry), the same snapshot, percentiles and histograms; counters
sharded per thread stay exact under concurrent ``incr``.  Modelled on the
reference's ``tests/test_metrics_registry.py``."""

from __future__ import annotations

import random
import re
import threading

import pytest

from bftkv_tpu.metrics import Metrics
from bftkv_tpu_torch import metrics as port_metrics
from bftkv_tpu_torch.metrics import BUCKETS, Registry, histogram_quantile


def _both(calls):
    port, ref = Registry(), Metrics()
    for m in (port, ref):
        for method, args, kw in calls:
            getattr(m, method)(*args, **kw)
    return port, ref


_CASES = {
    "scrapable": [
        ("incr", ("server.write.ok", 3), {}),
        ("incr", ("transport.rpcs", 5), {"labels": {"cmd": "sign", "transport": "loop"}}),
        ("gauge", ("dispatch.occupancy", 0.5), {}),
        ("observe", ("client.write.latency", 0.01), {}),
        ("observe", ("client.write.latency", 0.02), {}),
    ],
    "labels": [
        ("observe", ("client.write.latency", 0.01), {"labels": {"shard": 0}}),
        ("observe", ("client.write.latency", 0.3), {"labels": {"shard": 0}}),
        ("observe", ("client.write.latency", 0.004), {"labels": {"shard": 1}}),
        ("incr", ("rpc", 2), {"labels": {"side": "client", "cmd": "write"}}),
        ("incr", ("rpc",), {"labels": {"cmd": "read", "side": "server"}}),
        ("gauge", ("devbuf.in_flight", 3), {"labels": {"width": 64}}),
        ("gauge", ("devbuf.in_flight", 1), {"labels": {"width": 128}}),
        ("gauge", ("dispatch.crossover", 7), {}),
    ],
    "escaping": [
        ("incr", ("weird",), {"labels": {"v": 'a"b\\c\nd'}}),
        ("gauge", ("odd", 1.5), {"labels": {"v": 'q"\\\n'}}),
        ("observe", ("lat", 0.2), {"labels": {"v": 'x\n"y"'}}),
    ],
    "overflow": [
        ("observe", ("batch", 5.0), {}),
        ("observe", ("batch", 2e5), {}),  # past the last bucket: only +Inf counts it
        ("observe", ("batch", 1e9), {"labels": {"op": "verify"}}),
        ("observe", ("batch", -1.0), {"labels": {"op": "verify"}}),
    ],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_prometheus_text_equals_the_references(case):
    port, ref = _both(_CASES[case])
    assert port.prometheus() == ref.prometheus()
    assert port.snapshot() == ref.snapshot()
    assert port.histograms() == ref.histograms()


_PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})?'
    r" -?[0-9.eE+-]+(e[+-]?[0-9]+)?$"
)


def test_prometheus_exposition_is_scrapable():
    """The reference's scrapability checks on the port's text: one TYPE
    line a name, counters ``_total``, the observe() series a cumulative
    histogram whose ``+Inf`` bucket differs from the one before when a
    sample lies past the last bound."""
    port, _ = _both(_CASES["scrapable"] + _CASES["overflow"])
    text = port.prometheus()
    assert text.endswith("\n")
    typed = []
    for line in text.splitlines():
        if line.startswith("#"):
            m = re.match(r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) (counter|gauge|histogram)$", line)
            assert m, line
            typed.append(m.group(1))
            if m.group(2) == "counter":
                assert m.group(1).endswith("_total")
            continue
        assert _PROM_LINE.match(line), line
    assert len(typed) == len(set(typed))
    assert "bftkv_server_write_ok_total 3" in text
    assert "# TYPE bftkv_client_write_latency histogram" in text
    assert 'bftkv_client_write_latency_bucket{le="0.01"} 1' in text
    assert 'bftkv_client_write_latency_bucket{le="0.025"} 2' in text
    assert 'bftkv_client_write_latency_bucket{le="+Inf"} 2' in text
    assert "bftkv_client_write_latency_count 2" in text
    assert 'bftkv_batch_bucket{le="100000.0"} 1' in text
    assert 'bftkv_batch_bucket{le="+Inf"} 2' in text
    assert "summary" not in text


def test_label_keys_equal_the_references():
    from bftkv_tpu.metrics import LABEL_KEYS

    assert port_metrics.LABEL_KEYS == LABEL_KEYS
    assert "kind" in port_metrics.LABEL_KEYS


def test_concurrent_incr_from_16_threads_is_exact():
    """Counters sharded per thread: 16 threads × 10 000 ``incr`` give the
    exact totals while readers snapshot, and the snapshot equals the
    reference's fed the same calls."""
    port, ref = Registry(), Metrics()
    n_threads, per_thread = 16, 10_000
    stop = threading.Event()

    def writer(m, k):
        for _ in range(per_thread):
            m.incr("ops")
            m.incr("ops.by", labels={"t": str(k % 2)})

    def reader(m):
        while not stop.is_set():
            m.snapshot()
            m.prometheus()

    for m in (port, ref):
        readers = [threading.Thread(target=reader, args=(m,)) for _ in range(2)]
        writers = [threading.Thread(target=writer, args=(m, k)) for k in range(n_threads)]
        for t in readers + writers:
            t.start()
        for t in writers:
            t.join()
        stop.set()
        for t in readers:
            t.join()
        stop.clear()
    snap = port.snapshot()
    assert snap["ops"] == n_threads * per_thread
    assert snap["ops.by{t=0}"] + snap["ops.by{t=1}"] == n_threads * per_thread
    assert snap == ref.snapshot()
    assert port.prometheus() == ref.prometheus()
    port.reset()
    assert port.snapshot() == {} and port.prometheus() == "\n"
    port.incr("ops")
    assert port.snapshot() == {"ops": 1}


def test_percentile_and_histograms_equal_the_references():
    rng = random.Random(16)
    port, ref = Registry(), Metrics()
    series = [("lat", {"shard": 0}), ("lat", {"shard": 1}), ("batch", None)]
    for i in range(5000):
        name, labels = series[i % 3]
        v = rng.lognormvariate(-3, 2.5)
        port.observe(name, v, labels)
        ref.observe(name, v, labels)
    for name, labels in series + [("absent", None)]:
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert port.percentile(name, q, labels) == ref.percentile(name, q, labels)
    assert port.histograms() == ref.histograms()
    assert port.snapshot() == ref.snapshot()


def test_histograms_merge_across_instances():
    """The reference's fixed-ladder merge case on the port's registry."""
    a, b = Registry(), Registry()
    for v in (0.002, 0.002, 0.02):
        a.observe("lat", v, labels={"shard": 0})
    for v in (0.2, 0.2, 0.2, 7.0):
        b.observe("lat", v, labels={"shard": 0})
    ha = a.histograms()["lat{shard=0}"]
    hb = b.histograms()["lat{shard=0}"]
    assert len(ha["buckets"]) == len(BUCKETS) + 1
    merged = [x + y for x, y in zip(ha["buckets"], hb["buckets"])]
    assert sum(merged) == 7 and ha["count"] + hb["count"] == 7
    assert histogram_quantile(0.5, merged) == 0.25
    assert histogram_quantile(0.99, merged) == 10.0
    assert histogram_quantile(0.5, [0] * (len(BUCKETS) + 1)) is None
    snap = a.snapshot()
    assert snap["lat.bucket{shard=0,le=0.0025}"] == 2
    assert snap["lat.bucket{shard=0,le=0.025}"] == 1
    ra, rb = Metrics(), Metrics()
    for v in (0.002, 0.002, 0.02):
        ra.observe("lat", v, labels={"shard": 0})
    for v in (0.2, 0.2, 0.2, 7.0):
        rb.observe("lat", v, labels={"shard": 0})
    assert (a.histograms(), b.histograms()) == (ra.histograms(), rb.histograms())
