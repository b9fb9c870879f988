"""The port's observability surfaces against the reference's cases: the
sampling profiler (``bftkv_tpu_torch/obs/profiler.py``; ``tests/test_profiler.py``:
stack folding into collapsed-flamegraph lines, the memory bounds, the
disarmed on-demand window, the off-is-free arming contract) and the
visualizer transport (``bftkv_tpu_torch/transport/visual.py``;
``tests/test_visual.py``: WebSocket handshake, graph snapshot, request
feed of a port cluster on localhost HTTP, reference:
transport/http-visual/http-visual.go:43-173); ``obs.source``'s seat
document against the reference's; the metrics registry's fixed-bucket
counts (``name.bucket{...,le=…}``) against the reference's."""

from __future__ import annotations

import base64
import hashlib
import json
import os
import socket
import struct
import sys
import threading
import time

import pytest

from bftkv_tpu_torch import topology
from bftkv_tpu_torch.obs import profiler
from bftkv_tpu_torch.protocol.client import Client
from bftkv_tpu_torch.protocol.server import Server
from bftkv_tpu_torch.storage.memkv import MemStorage
from bftkv_tpu_torch.transport.http import TrHTTP
from bftkv_tpu_torch.transport.visual import TrVisual, WsHub

from test_torch_utils import DEVICE, build_universe, free_port_block


# -- the profiler ------------------------------------------------------------


def _parked(evt):
    evt.wait(10)


def _parked_too(evt):
    evt.wait(10)


def _deep(n, evt):
    if n:
        return _deep(n - 1, evt)
    evt.wait(10)


def _spawn(target, *args):
    evt = threading.Event()
    t = threading.Thread(target=target, args=args + (evt,), daemon=True)
    t.start()
    # the helper must be parked inside its wait before we sample
    for _ in range(200):
        frame = sys._current_frames().get(t.ident)
        if frame is not None and "wait" in frame.f_code.co_name:
            break
        time.sleep(0.005)
    return t, evt


def test_sample_once_folds_parked_threads_root_to_leaf():
    t, evt = _spawn(_parked)
    try:
        p = profiler.Profiler()
        assert p.sample_once() >= 1
        out = p.collapsed()
        assert out.startswith("# bftkv profile:")
        line = next(
            l for l in out.splitlines()[1:] if "_parked;" in l
        )
        stack, count = line.rsplit(" ", 1)
        assert int(count) >= 1
        # collapsed format runs root -> leaf: the parked helper's
        # frame precedes the Event.wait frames it called into
        assert stack.index("_parked") < stack.index("wait")
        assert "test_torch_obs.py:_parked" in stack
    finally:
        evt.set()
        t.join()


def test_max_stacks_bound_folds_overflow():
    t1, e1 = _spawn(_parked)
    t2, e2 = _spawn(_parked_too)
    try:
        p = profiler.Profiler(max_stacks=1)
        p.sample_once()
        with p._lock:
            assert len(p._counts) == 1
            assert p._overflow >= 1  # >= 2 distinct stacks were live
        assert "<overflow>" in p.collapsed()
    finally:
        e1.set()
        e2.set()
        t1.join()
        t2.join()


def test_max_depth_keeps_the_leaf_side():
    t, evt = _spawn(_deep, 60)
    try:
        p = profiler.Profiler(max_depth=5)
        frame = sys._current_frames()[t.ident]
        stack = p._fold(frame)
        # the root side folds into <deep>; the hot leaf survives
        assert stack.startswith("<deep>;")
        assert stack.count(";") == 5
        assert "wait" in stack.rsplit(";", 2)[-1] or "_deep" in stack
    finally:
        evt.set()
        t.join()


def test_disarmed_is_off_and_profile_for_still_works(monkeypatch):
    monkeypatch.delenv("BFTKV_PROFILE", raising=False)
    assert profiler.enabled() is False
    # off = no thread, no global sampler at all
    assert profiler.ensure_started() is None
    # ...but a demand window still answers, via a TEMPORARY sampler
    out = profiler.profile_for(0.05)
    assert out.startswith("# bftkv profile:")
    # the window is what the flight recorder snapshots into bundles
    assert profiler.last() == out


def test_armed_starts_one_continuous_sampler(monkeypatch):
    monkeypatch.setenv("BFTKV_PROFILE", "1")
    saved = profiler._global
    profiler._global = None
    try:
        p = profiler.ensure_started()
        assert p is not None and p.running()
        assert profiler.ensure_started() is p  # started once
        t, evt = _spawn(_parked)
        try:
            deadline = time.time() + 5
            while time.time() < deadline:
                with p._lock:
                    if any("_parked" in s for s in p._counts):
                        break
                time.sleep(0.02)
            else:
                pytest.fail("continuous sampler never saw the "
                            "parked thread")
        finally:
            evt.set()
            t.join()
    finally:
        if profiler._global is not None:
            profiler._global.stop()
        profiler._global = saved


def test_armed_window_overhead_parity_smoke(monkeypatch):
    """The 67 Hz comb must be invisible to foreground work: a tight
    CPU loop with the sampler running stays near parity with the same
    loop alone.  Median-of-5 with a generous bound (the CI perf smoke
    holds the real 5% bar on the full write path, where the loop body
    dwarfs the sampler's per-tick cost)."""
    def cycle(n=200_000):
        t0 = time.perf_counter()
        acc = 0
        for i in range(n):
            acc += i
        return time.perf_counter() - t0

    cycle()  # warm
    p = profiler.Profiler(hz=67)
    ratios = []
    for _ in range(5):
        off = cycle()
        p.start()
        try:
            on = cycle()
        finally:
            p.stop()
        ratios.append(on / max(off, 1e-9))
    ratios.sort()
    assert ratios[2] < 1.5, ratios

# -- the visualizer transport ------------------------------------------------


def _ws_connect(port: int) -> tuple[socket.socket, bytes]:
    """Returns (socket, leftover): frames pushed right after the 101
    can land in the same recv as the handshake response."""
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    key = base64.b64encode(os.urandom(16)).decode()
    s.sendall(
        (
            "GET / HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
            f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
            "Sec-WebSocket-Version: 13\r\n\r\n"
        ).encode()
    )
    resp = b""
    while b"\r\n\r\n" not in resp:
        resp += s.recv(4096)
    head, _, leftover = resp.partition(b"\r\n\r\n")
    assert b"101" in head.split(b"\r\n")[0]
    want = base64.b64encode(
        hashlib.sha1(
            (key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11").encode()
        ).digest()
    )
    assert want in head
    return s, leftover


def _read_frames(s: socket.socket, timeout: float = 10.0, initial: bytes = b""):
    s.settimeout(timeout)
    buf = initial
    while True:
        try:
            while True:
                # parse as many complete frames as buffered
                if len(buf) >= 2:
                    ln = buf[1] & 0x7F
                    off = 2
                    if ln == 126:
                        if len(buf) < 4:
                            pass
                        ln = struct.unpack(">H", buf[2:4])[0]
                        off = 4
                    if len(buf) >= off + ln:
                        yield json.loads(buf[off : off + ln])
                        buf = buf[off + ln :]
                        continue
                break
            chunk = s.recv(65536)
            if not chunk:
                return
            buf += chunk
        except socket.timeout:
            return


def test_visual_feed_end_to_end():
    uni = build_universe(4, 1, 4, transport="http")
    ws_port = free_port_block(1)
    hub = WsHub(("127.0.0.1", ws_port))
    servers = []
    try:
        for i, ident in enumerate(uni.servers + uni.storage_nodes):
            graph, crypt, qs = topology.make_node(ident, uni.view_of(ident), device=DEVICE)
            # first server narrates to the hub; the rest are plain HTTP
            tr = TrVisual(crypt, hub, graph) if i == 0 else TrHTTP(crypt)
            srv = Server(graph, qs, tr, crypt, MemStorage(), device=DEVICE)
            srv.start()
            servers.append(srv)

        ws, leftover = _ws_connect(ws_port)
        time.sleep(0.2)

        g, cr, q = topology.make_node(uni.users[0], uni.view_of(uni.users[0]), device=DEVICE)
        client = Client(g, q, TrHTTP(cr), cr, device=DEVICE)
        client.write(b"vis/x", b"hello")
        assert client.read(b"vis/x") == b"hello"

        events = list(_read_frames(ws, timeout=3.0, initial=leftover))
        types = {e["type"] for e in events}
        assert "graph" in types, events
        cmds = {e.get("command") for e in events if e["type"] == "request"}
        # the narrated node served at least one write-path command
        # (write_sign = the collapsed round; time/sign/write = the
        # classic rounds and the certify/back-fill deliveries)
        assert {"time", "sign", "write", "write_sign", "batch_write"} & cmds, events
        graph_evt = next(e for e in events if e["type"] == "graph")
        assert any(n["self"] for n in graph_evt["nodes"])
        assert graph_evt["edges"]
        ws.close()
    finally:
        for srv in servers:
            srv.tr.stop()
        hub.stop()


def test_visual_page_exists():
    page = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "visual", "index.html",
    )
    with open(page) as f:
        body = f.read()
    assert "WebSocket" in body and "drawGraph" in body


# -- obs.source ---------------------------------------------------------------


def test_seat_document_equals_the_references():
    """The daemon's ``/info`` seat half from the same quorum state: the
    port's ``seat_document`` over a port node equals the reference's over a
    reference node of the same home, for a clique server, a storage node
    and a user; and a quorum system without ``seat_info`` gets the
    defaults."""
    import tempfile

    from bftkv_tpu import topology as ref_topology
    from bftkv_tpu.obs.source import seat_document as ref_seat
    from bftkv_tpu_torch.obs.source import seat_document

    uni = build_universe(4, 1, 4)
    with tempfile.TemporaryDirectory() as root:
        for ident in (uni.servers[0], uni.storage_nodes[0], uni.users[0]):
            home = os.path.join(root, ident.name)
            topology.save_home(home, ident, uni.view_of(ident))
            g, _c, qs = topology.load_home(home, device=DEVICE)
            rg, _rc, rqs = ref_topology.load_home(home)
            assert seat_document(qs, g.get_self_id()) == ref_seat(rqs, rg.get_self_id())
    assert seat_document(object(), 1) == ref_seat(object(), 1)


# -- the registry's fixed-bucket counts ---------------------------------------


def test_bucket_counts_equal_the_references():
    """The same observations (every bucket edge, values between and past
    the ladder, negative and zero ones, labelled and unlabelled series)
    give the port's ``Registry.snapshot()`` the reference's
    ``name.bucket{...,le=…}`` keys with the same counts, one key per
    non-empty bucket, beside equal ``.count``/``.sum`` and
    ``histogram_quantile`` estimates of the merged buckets; the series'
    p50/p99 keys stay."""
    import random

    from bftkv_tpu.metrics import BUCKETS as REF_BUCKETS
    from bftkv_tpu.metrics import Metrics, _bucket_index as ref_index
    from bftkv_tpu.metrics import histogram_quantile as ref_quantile
    from bftkv_tpu_torch.metrics import BUCKETS, Registry, _bucket_index, histogram_quantile

    assert BUCKETS == REF_BUCKETS
    edges = [b for b in BUCKETS] + [b * (1 + 1e-12) for b in BUCKETS] + [-1.0, 0.0, 1e9]
    assert [_bucket_index(v) for v in edges] == [ref_index(v) for v in edges]
    port, ref = Registry(), Metrics()
    rng = random.Random(15)
    series = [("client.write.latency", {"shard": 0}), ("client.write.latency", {"shard": 1}),
              ("client.read.latency", None), ("dispatch.batch", None),
              ("admission.wait", {"resource": "sidecar"})]
    for i in range(3000):
        name, labels = series[i % len(series)]
        v = edges[i % len(edges)] if i % 3 == 0 else rng.lognormvariate(-3, 2.5)
        port.observe(name, v, labels)
        ref.observe(name, v, labels)
    ps, rs = port.snapshot(), ref.snapshot()
    pb = {k: v for k, v in ps.items() if ".bucket{" in k}
    rb = {k: v for k, v in rs.items() if ".bucket{" in k}
    assert pb == rb and len(pb) > 40 and all(v > 0 for v in pb.values())
    for k in ps:
        if k.endswith((".count", ".p50", ".p99")) or ".count{" in k or ".p50{" in k or ".p99{" in k:
            assert ps[k] == rs[k], k
    for k in rs:
        if ".sum" in k:
            assert ps[k] == pytest.approx(rs[k]), k
    # The collector's merge: sum the per-bucket counts of a series.
    for name in ("client.write.latency", "client.read.latency"):
        vec = [0] * (len(BUCKETS) + 1)
        for k, c in pb.items():
            if k.startswith(name + ".bucket{"):
                le = k.rsplit("le=", 1)[1].rstrip("}")
                vec[len(BUCKETS) if le == "+Inf" else BUCKETS.index(float(le))] += c
        for q in (0.5, 0.9, 0.99):
            assert histogram_quantile(q, vec) == ref_quantile(q, vec)
    port.reset()
    assert not [k for k in port.snapshot() if ".bucket" in k]
