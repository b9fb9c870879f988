"""The hand-written kernels on the card (skips where there is no CUDA).

Each kernel against its plain PyTorch version on the same device tensors
(exact: every value is an integer), and the entry points and domains on
``cuda`` against host ``pow``/``sign``, with the launches counted.  This
file imports neither ``jax`` nor the reference package, so it runs on a
GPU machine without JAX:

    BFTKV_TPU_LANE=1 python3 -m pytest tests/test_torch_cuda.py -m cuda -q
"""

from __future__ import annotations

import functools
import random
import threading

import numpy as np
import pytest
import torch

from bftkv_tpu_torch.crypto import rsa
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.ops import cuda_mont, cuda_rns, limb, modexp, rns
from bftkv_tpu_torch.ops import rsa as rsa_ops
from bftkv_tpu_torch.tools.time_rns import mont_operands
from test_torch_utils import moduli as _moduli

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels have no CPU mode")
    return torch.device("cuda", 0)


def test_k1_matches_plain_on_card(dev):
    ctx = rns.context()
    ns = _moduli(ctx, 2048, 4, seed=21)
    rng = random.Random(22)
    n_rows = 300  # not a multiple of the kernel's rows per block
    idx = np.array([rng.randrange(4) for _ in range(n_rows)], dtype=np.int32)
    sigs = [rng.randrange(ns[i]) for i in idx]
    ems = [pow(s, 65537, ns[i]) if j % 2 else rng.randrange(ns[i])
           for j, (s, i) in enumerate(zip(sigs, idx))]
    sh = rns.digits_to_halves_u8(np.stack([limb.int_to_limbs(s, 128) for s in sigs]))
    eh = rns.digits_to_halves_u8(np.stack([limb.int_to_limbs(e, 128) for e in ems]))
    ukey = rns.key_rows_from_numpy(
        rns.stack_key_rows([ctx.key_rows(n) for n in ns]), dev
    )
    cn = rns.consts(128, 2048, dev)
    args = (torch.from_numpy(sh).to(dev), torch.from_numpy(eh).to(dev),
            torch.from_numpy(idx).to(dev))
    got = cuda_rns.verify_cuda(*args, ukey, cn).cpu().numpy()
    plain = rns._verify_kernel(
        cn, args[0], args[1], rns.gather_key(ukey, args[2])
    ).cpu().numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, [j % 2 == 1 for j in range(n_rows)])


def _k1_operands(dev, n_rows: int, n_keys: int, seed: int):
    """Seeded K1 operands at k=188: odd rows valid signatures, even rows a
    random em; plus the host verdicts."""
    ctx = rns.context()
    ns = _moduli(ctx, 2048, n_keys, seed=seed)
    rng = random.Random(seed + 1)
    idx = np.array([rng.randrange(n_keys) for _ in range(n_rows)], dtype=np.int32)
    sigs = [rng.randrange(ns[i]) for i in idx]
    ems = [pow(s, 65537, ns[i]) if j % 2 else rng.randrange(ns[i])
           for j, (s, i) in enumerate(zip(sigs, idx))]
    halves = lambda xs: torch.from_numpy(
        rns.digits_to_halves_u8(np.stack([limb.int_to_limbs(x, 128) for x in xs]))).to(dev)
    ukey = rns.key_rows_from_numpy(rns.stack_key_rows([ctx.key_rows(n) for n in ns]), dev)
    args = (halves(sigs), halves(ems), torch.from_numpy(idx).to(dev), ukey,
            rns.consts(128, 2048, dev))
    return args, [j % 2 == 1 for j in range(n_rows)]


@pytest.mark.parametrize("size", ["one_row", "rows_per_block_plus_one", "fault_check"])
def test_k1_small_batches_match_plain_on_card(dev, size):
    """T = 1, T = R + 1 (R = K1's rows per block: a last block with one live
    slot) and T = 256 (a sign flush's fault check)."""
    rows = {"one_row": 1, "fault_check": 256,
            "rows_per_block_plus_one": cuda_rns.kernel_attrs()["verify"]["rows_per_block"] + 1}[size]
    args, want = _k1_operands(dev, rows, 3, seed=81 + rows)
    got = cuda_rns.verify_cuda(*args)
    plain = rns._verify_kernel(args[4], args[0], args[1], rns.gather_key(args[3], args[2]))
    assert torch.equal(got, plain)
    assert got.cpu().tolist() == want


def test_k1_fails_a_bad_key_index_closed_and_writes_no_row_past_t(dev):
    """A key index of n_keys gets verdict 0 (its signature is valid under
    key row 0, which the kernel reads instead); its neighbours keep their
    verdicts; with T = 13 the 11 words after the output stay as they were."""
    t, n_keys = 13, 3
    (sh, eh, idx, ukey, cn), want = _k1_operands(dev, t, n_keys, seed=91)
    ctx = rns.context()
    n0 = _moduli(ctx, 2048, n_keys, seed=91)[0]
    s0 = random.Random(92).randrange(n0)
    row = lambda x: torch.from_numpy(rns.digits_to_halves_u8(limb.int_to_limbs(x, 128)[None])).to(dev)
    sh[5], eh[5] = row(s0)[0], row(pow(s0, 65537, n0))[0]
    idx[5] = n_keys
    buf = torch.full((t + 11,), 7, dtype=torch.int32, device=dev)
    cuda_rns._launch("verify", sh, eh, idx, ukey, cn, buf[:t])
    assert buf[t:].cpu().tolist() == [7] * 11
    clamped = torch.where(idx < n_keys, idx, torch.zeros_like(idx))
    plain = rns._verify_kernel(cn, sh, eh, rns.gather_key(ukey, clamped))
    assert bool(plain[5])  # key row 0 would pass it: the index check fails it
    want[5] = False
    assert (buf[:t] != 0).cpu().tolist() == want
    assert torch.equal(buf[:t] != 0, plain & (idx < n_keys))


def test_k2_matches_plain_on_card(dev):
    ctx = rns.context(64, 1024)
    ns = _moduli(ctx, 1024, 4, seed=23)
    rng = np.random.default_rng(24)
    n_rows = 66  # not a multiple of the kernel's rows per block
    idx = torch.as_tensor(rng.integers(0, 4, n_rows).astype(np.int32), device=dev)
    bh = torch.as_tensor(rng.integers(0, 256, (n_rows, 128)).astype(np.uint8), device=dev)
    nib = torch.as_tensor(rng.integers(0, 16, (256, n_rows)).astype(np.uint8), device=dev)
    ukey = rns.key_rows_from_numpy(
        rns.stack_key_rows([ctx.key_rows(n) for n in ns]), dev
    )
    cn = rns.consts(64, 1024, dev)
    got = cuda_rns.pow_cuda(bh, nib, idx, ukey, cn)
    plain = rns._pow_kernel(cn, bh, nib, rns.gather_key(ukey, idx))
    assert torch.equal(got.long(), plain)


def test_entry_points_on_card_match_host_pow(dev):
    ctx = rns.context(64, 1024)
    mods = _moduli(ctx, 1024, 3, seed=25)
    rng = random.Random(26)
    rows = [mods[i % 3] for i in range(70)]
    bases = [rng.getrandbits(2048) for _ in rows]
    exps = [rng.getrandbits(1024) for _ in rows]
    cuda_rns.reset_launches()
    out = rns.power_mod_rns(bases, exps, rows, n_bits=1024, defer=True, device=dev)
    assert out.wait() == [pow(b, e, m) for b, e, m in zip(bases, exps, rows)]
    assert cuda_rns.LAUNCHES == {"verify": 0, "pow": 1}


def test_domains_on_card_match_host(dev):
    keys = [rsa.generate(2048, seed=s) for s in (31, 32)]
    items = [(b"m%d" % i, keys[i % 2]) for i in range(6)]
    cuda_rns.reset_launches()
    sigs = rsa.SignerDomain(device=dev, host_threshold=0).sign_batch(items)
    assert sigs == [rsa.sign(m, k) for m, k in items]
    assert cuda_rns.LAUNCHES == {"verify": 1, "pow": 1}  # sign + fault check
    vitems = [(m, s if i % 3 else s[:-1] + bytes([s[-1] ^ 1]), k.public)
              for i, ((m, k), s) in enumerate(zip(items, sigs))]
    got = rsa.VerifierDomain(device=dev, host_threshold=0).verify_batch(vitems)
    np.testing.assert_array_equal(got, [i % 3 != 0 for i in range(6)])
    assert cuda_rns.LAUNCHES == {"verify": 2, "pow": 1}


def test_k3_matches_plain_on_card(dev):
    ops, want = mont_operands(512, 41, dev)
    cuda_mont.reset_launches()
    got = cuda_mont.verify_diff(*ops)
    plain = rsa_ops._verify_chain(*(a.long() for a in ops))
    assert torch.equal(got.long(), plain)  # the whole diff, not only verdicts
    assert cuda_mont.verify_cuda(*ops).cpu().tolist() == want
    assert cuda_mont.LAUNCHES == {"mont_verify": 2}
    with pytest.raises(ValueError, match="multiple of 256"):
        cuda_mont.verify_cuda(*(a[:300] for a in ops))


@pytest.mark.parametrize("rows", [256, 4096])
def test_k3_matches_plain_on_hostile_rows_on_card(dev, rows):
    """The moduli 2^2048 - 1 and 2^2047 + 1, s = n - 1, (n-1)^2 as the first
    squaring, all-ones words, s = 0 and s >= n, at the smallest pallas flush
    (the domain pads to 256 rows) and the 4096-item one: the whole diff
    bit-identical to the plain version."""
    ops, want = mont_operands(rows, 43, dev)
    cuda_mont.reset_launches()
    got = cuda_mont.verify_diff(*ops)
    plain = rsa_ops._verify_chain(*(a.long() for a in ops))
    assert torch.equal(got.long(), plain)
    assert (got == 0).all(dim=-1).cpu().tolist() == want
    assert cuda_mont.LAUNCHES == {"mont_verify": 1}


def test_k3_uses_no_local_memory(dev):
    attrs = cuda_mont.kernel_attrs()["mont_verify"]
    assert attrs["local_bytes"] == 0  # no spills, no stack
    assert 0 < attrs["registers"] <= 255
    assert attrs["rows_per_block"] * attrs["threads_per_row"] % 32 == 0


def test_k2_at_2048_bits_matches_plain_on_card(dev):
    ctx = rns.context(128, 2048)
    ns = _moduli(ctx, 2048, 3, seed=43)
    rng = np.random.default_rng(44)
    n_rows = 7  # not a multiple of the kernel's rows per block
    idx = torch.as_tensor(rng.integers(0, 3, n_rows).astype(np.int32), device=dev)
    bh = torch.as_tensor(rng.integers(0, 256, (n_rows, 256)).astype(np.uint8), device=dev)
    nib = torch.as_tensor(rng.integers(0, 16, (512, n_rows)).astype(np.uint8), device=dev)
    ukey = rns.key_rows_from_numpy(rns.stack_key_rows([ctx.key_rows(n) for n in ns]), dev)
    cn = rns.consts(128, 2048, dev)
    got = cuda_rns.pow_cuda(bh, nib, idx, ukey, cn)
    assert torch.equal(got.long(), rns._pow_kernel(cn, bh, nib, rns.gather_key(ukey, idx)))
    r = random.Random(45)
    rows = [ns[i % 3] for i in range(9)]
    bases = [r.getrandbits(2048) for _ in rows]
    exps = [r.getrandbits(2048) for _ in rows]
    assert rns.power_mod_rns(bases, exps, rows, n_bits=2048, device=dev) == [
        pow(b, e, m) for b, e, m in zip(bases, exps, rows)
    ]


@pytest.mark.parametrize("digits,n_bits", [(64, 1024), (128, 2048)])
@pytest.mark.parametrize("size", ["one_row", "rows_per_block_plus_one"])
def test_k2_small_batches_match_plain_on_card(dev, digits, n_bits, size):
    """T = 1, and T = R + 1 (R = K2's rows per block): one block with a
    single stored row, and a last block whose slots repeat one row."""
    rows = 1 if size == "one_row" else cuda_rns.kernel_attrs()["pow"]["rows_per_block"] + 1
    ctx = rns.context(digits, n_bits)
    ns = _moduli(ctx, n_bits, 2, seed=47)
    rng = np.random.default_rng(48 + rows)
    idx = torch.as_tensor(rng.integers(0, 2, rows).astype(np.int32), device=dev)
    bh = torch.as_tensor(rng.integers(0, 256, (rows, 2 * digits)).astype(np.uint8), device=dev)
    nib = torch.as_tensor(rng.integers(0, 16, (4 * digits, rows)).astype(np.uint8), device=dev)
    ukey = rns.key_rows_from_numpy(rns.stack_key_rows([ctx.key_rows(n) for n in ns]), dev)
    cn = rns.consts(digits, n_bits, dev)
    got = cuda_rns.pow_cuda(bh, nib, idx, ukey, cn)
    assert torch.equal(got.long(), rns._pow_kernel(cn, bh, nib, rns.gather_key(ukey, idx)))


def test_k2_refuses_a_context_the_card_cannot_hold(dev):
    """k=255 channels at 256 digits: K2's int8 extension planes alone
    (4 x 256 x 256 bytes) exceed the shared memory the card allows a
    block; the launch raises with the byte count."""
    k, digits = 255, 256
    p_all = np.arange(3, 3 + 4 * k, 2, dtype=np.float32)
    z = lambda *shape: np.zeros(shape, np.float32)
    arrays = dict(
        p_all=p_all, inv_all=np.float32(1.0) / p_all, invMi_b=z(k), invMi_q=z(k),
        _E1=(z(k, k + 1), z(k, k + 1)), _E2=(z(k, k + 1), z(k, k + 1)),
        _D=(z(2 * digits, 2 * k + 1), z(2 * digits, 2 * k + 1)),
        Mq_mod_b=z(k), invMq_pr=np.float32(1), invM_q=z(k), invM_pr=np.float32(1),
    )
    cn = rns.consts_from_numpy(arrays, dev)
    ukey = rns.key_rows_from_numpy(
        tuple(z(1, w) for w in (2 * k, 1, k, 2 * k, 2 * k, 1)), dev
    )
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    before = dict(cuda_rns.LAUNCHES)
    with pytest.raises(RuntimeError, match=r"k=255, 256 digits needs \d+ bytes"):
        cuda_rns.pow_cuda(
            torch.zeros((1, 2 * digits), dtype=torch.uint8, device=dev),
            torch.zeros((4 * digits, 1), dtype=torch.uint8, device=dev), one, ukey, cn,
        )
    assert cuda_rns.LAUNCHES == before


def test_limb_and_pallas_domains_on_card_match_host(dev):
    keys = [rsa.generate(2048, seed=s) for s in (51, 52)]
    items = [(b"m%d" % i, keys[i % 2]) for i in range(5)]
    cuda_rns.reset_launches()
    metrics.reset()
    sigs = rsa.SignerDomain(device=dev, host_threshold=0, backend="limb").sign_batch(items)
    assert sigs == [rsa.sign(m, k) for m, k in items]
    assert metrics.snapshot()["sign.device"] == 5
    assert cuda_rns.LAUNCHES == {"verify": 1, "pow": 0}  # the fault check only
    vitems = [(m, s if i % 2 else s[:-1] + bytes([s[-1] ^ 1]), k.public)
              for i, ((m, k), s) in enumerate(zip(items, sigs))]
    want = [i % 2 == 1 for i in range(5)]
    cuda_mont.reset_launches()
    for backend, k3 in (("limb", 0), ("pallas", 1)):
        dom = rsa.VerifierDomain(device=dev, host_threshold=0, backend=backend)
        np.testing.assert_array_equal(dom.verify_batch(vitems), want)
        assert cuda_mont.LAUNCHES == {"mont_verify": k3}


def test_batch_modexp_on_card_matches_host_pow(dev):
    rng = random.Random(53)
    n = rng.getrandbits(2048) | 1 | (1 << 2047)
    bme = modexp.BatchModExp(device=dev)
    pairs = [(rng.getrandbits(2048), rng.getrandbits(2048)) for _ in range(6)]
    cuda_rns.reset_launches()
    assert bme.modexp(pairs, n) == [pow(b, e, n) for b, e in pairs]
    assert cuda_rns.LAUNCHES["pow"] == 1  # RNS at k=188
    n = rng.getrandbits(512) | 1 | (1 << 511)
    pairs = [(rng.getrandbits(600), rng.getrandbits(2300)) for _ in range(4)]
    assert bme.modexp(pairs, n) == [pow(b, e, n) for b, e in pairs]
    assert cuda_rns.LAUNCHES["pow"] == 1  # the limb path launches no kernel


def test_pipelined_workers_on_two_streams_match_the_synchronous_path(dev, monkeypatch):
    """Verify flushes through two flush workers, each on its own stream,
    with a ring of two slots reused under load by many small flushes: the
    verdicts equal the synchronous path's (one flush at a time, no rings)
    bit for bit, and host pow."""
    from bftkv_tpu_torch.ops import devbuf, dispatch

    keys = [rsa.generate(2048, seed=s) for s in (61, 62)]
    rng = random.Random(63)
    items, want = [], []
    for i in range(192):
        key = keys[i % 2]
        msg = b"pipelined-%d" % i
        sig = rsa.sign(msg, key)
        if rng.random() < 0.25:
            sig = sig[:-1] + bytes([sig[-1] ^ 1])
        items.append((msg, sig, key.public))
        want.append(rsa.verify_host(msg, sig, key.public))

    def run(pipeline: int) -> tuple[list[bool], set[int]]:
        streams: set[int] = set()
        real = cuda_rns.verify_cuda

        def spy(*a):
            streams.add(torch.cuda.current_stream(dev).cuda_stream)
            return real(*a)

        monkeypatch.setattr(cuda_rns, "verify_cuda", spy)
        d = dispatch.VerifyDispatcher(
            rsa.VerifierDomain(device=dev, host_threshold=0),
            max_batch=16, max_wait=0.0005, pipeline=pipeline, calibrate=False,
        ).start()
        out: dict[int, list[bool]] = {}
        try:
            def submit(t):
                out[t] = [bool(v) for v in d.verify(items[t * 12:(t + 1) * 12])]

            threads = [threading.Thread(target=submit, args=(t,)) for t in range(16)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(300)
            assert not any(th.is_alive() for th in threads)
        finally:
            d.stop()
            monkeypatch.setattr(cuda_rns, "verify_cuda", real)
        return [v for t in range(16) for v in out[t]], streams

    monkeypatch.setenv("BFTKV_DISPATCH_DEVBUF", "off")
    sync, sync_streams = run(1)
    monkeypatch.setenv("BFTKV_DISPATCH_DEVBUF", "on")
    monkeypatch.setenv("BFTKV_DISPATCH_DEVBUF_RING", "2")
    devbuf.reset()
    piped, piped_streams = run(2)
    assert sync == piped == want
    assert len(sync_streams) == 1 and len(piped_streams) == 2
    default = torch.cuda.default_stream(dev).cuda_stream
    assert default not in piped_streams
    (ring,) = [r for r in devbuf.stats().values() if r["width"] == "verify"]
    assert ring["acquires"] + ring["overflows"] >= 12  # several flushes per slot
    assert ring["in_flight"] == 0
    devbuf.reset()


def test_modexp_dispatcher_at_rsa3072_halves(dev):
    """1536-bit moduli (the CRT halves of RSA-3072, k = 141) and 1024-bit
    ones in one ModexpDispatcher flush: both width groups' K2 launches go
    on the stream before the first wait; every result equals host pow."""
    from bftkv_tpu_torch.ops import devbuf, dispatch

    ctx3072 = rns.context(96, 1536)
    assert 135 <= ctx3072.k <= 145
    m1536 = _moduli(ctx3072, 1536, 3, seed=71)
    m1024 = _moduli(rns.context(64, 1024), 1024, 2, seed=72)
    rng = random.Random(73)
    items = [(rng.getrandbits(1600), rng.getrandbits(1536), m1536[i % 3]) for i in range(20)]
    items += [(rng.getrandbits(1024), rng.getrandbits(1024), m1024[i % 2]) for i in range(12)]
    cuda_rns.reset_launches()
    metrics.reset()
    at_first_wait = []
    real_wait = rns.DeferredModexp.wait

    def wait(self):
        if not at_first_wait:
            at_first_wait.append(cuda_rns.LAUNCHES["pow"])
        return real_wait(self)

    rns.DeferredModexp.wait = wait
    d = dispatch.ModexpDispatcher(device=dev, device_threshold=2, calibrate=False,
                                  max_wait=0.01).start()
    try:
        assert d.submit(items) == [pow(b, e, m) for b, e, m in items]
    finally:
        d.stop()
        rns.DeferredModexp.wait = real_wait
    assert at_first_wait == [2] and cuda_rns.LAUNCHES["pow"] == 2
    assert metrics.snapshot()["modexp.device"] == len(items)
    assert all(r["in_flight"] == 0 for r in devbuf.stats().values())


def test_observed_launch_rtt_prices_the_card_crossover(dev, monkeypatch):
    """On the card, round trips that flushes observed outrank a fresh probe
    (the reference's online recalibration)."""
    from bftkv_tpu_torch.ops import dispatch

    monkeypatch.delenv("BFTKV_DISPATCH_CROSSOVER", raising=False)
    monkeypatch.setattr(dispatch, "_LAUNCH_RTT_EWMA", None)
    cal = dispatch.calibration(force=True, device=dev)
    assert cal["source"] == "probe" and cal["prefer_host"] is False
    dispatch.note_launch_rtt(0.05)
    cal = dispatch.calibration(force=True, device=dev)
    assert cal["source"] == "observed" and cal["device_rtt_s"] == 0.05
    assert cal["verify_crossover"] == max(16, int(0.05 / cal["host_verify_s"]))
    monkeypatch.setattr(dispatch, "_LAUNCH_RTT_EWMA", None)
    dispatch.calibration(force=True, device=dev)


def test_ring_never_hands_out_inflight_slot_on_card(dev):
    """The ring's ownership rules with pinned host and device tensors: a
    slot whose copy is still queued behind device work goes back to the
    ring only once the event behind it has completed."""
    from bftkv_tpu_torch.ops import devbuf

    n = 1 << 20
    ring = devbuf.BufferRing("card:ring", {"a": ((n,), torch.uint8)}, dev, slots=2, width="t")
    s1, s2 = ring.acquire(), ring.acquire()
    assert s1 is not s2 and s1.host["a"].is_pinned() and s1.dev["a"].device == dev
    assert ring.acquire() is None and ring.overflows == 1
    torch.cuda._sleep(100_000_000)  # tens of ms of device time ahead of the copy
    s1["a"][:] = 1
    s1.upload(("a",))
    s1.record()
    assert not s1.event.query()  # the copy is still in flight
    seq = s1.seq
    ring.release(s1, seq)
    assert s1.event.query()  # release waited for the event behind it
    s3 = ring.acquire()
    assert s3 is s1 and s3.seq == seq + 1
    assert int(s3.dev["a"].sum()) == n
    with pytest.raises(RuntimeError, match="stale release"):
        ring.release(s3, seq)
    ring.release(s2)
    with pytest.raises(RuntimeError, match="not in flight"):
        ring.release(s2)


# -- K5: the P-256 scalar mult -------------------------------------------------


def _raw_nibbles(s: int) -> list[int]:
    """The 64 window values of ``s`` itself, most significant first: unlike
    ``ec_rns._nibbles``, not reduced mod n."""
    return [(s >> (4 * (63 - w))) & 0xF for w in range(64)]


#: Lanes of :func:`_k5_operands` whose nibble column holds the raw windows
#: of n and n + 1: the accumulator before the last add is −(n mod 16)·G,
#: so n's last add is P + (−P) (an exact-0 Z) and n + 1's is a plain add.
_K5_RAW_N, _K5_RAW_N1 = 6, 7


def _k5_operands(dev, t: int, seed: int):
    """Staged K5 operands at T = t: the edge lanes first — identity points,
    scalars 0, 1, 2 (the doubling lane 2·G), n − 1, then the raw windows
    of n (whose last add is P + (−P)) and of n + 1, then 3 — then seeded
    random points and scalars.  Returns the scalars each lane computes."""
    from bftkv_tpu_torch.crypto.ec import P256
    from bftkv_tpu_torch.ops import ec_rns

    g = (P256.gx, P256.gy)
    rng = random.Random(seed)
    pts = [None, None, g, g, g, g, g, g, g]
    ks = [5, 0, 0, 1, 2, P256.n - 1, P256.n, P256.n + 1, 3]
    while len(pts) < t:
        pts.append(P256.scalar_base_mult(rng.randrange(1, P256.n)) if len(pts) < 24 else g)
        ks.append(rng.randrange(P256.n))
    pts, ks = pts[:t], ks[:t]
    eng = ec_rns.engine(dev)
    block = np.zeros((3, 2 * eng.k + 1, t), dtype=np.int32)
    ec_rns.engine("cpu").encode_points_into(pts, block)
    nib = ec_rns._nibbles(ks)
    for lane in (_K5_RAW_N, _K5_RAW_N1):
        if lane < t:
            nib[:, lane] = _raw_nibbles(ks[lane])
    res = torch.from_numpy(block).to(dev)
    return eng, res, torch.from_numpy(nib).to(dev), pts, ks


@pytest.mark.parametrize("t", [8, 256, 2048])
def test_k5_matches_plain_on_card(dev, t):
    from bftkv_tpu_torch.crypto.ec import P256
    from bftkv_tpu_torch.ops import cuda_ec, ec_rns

    eng, res, nib, pts, ks = _k5_operands(dev, t, seed=t)
    cuda_ec.reset_launches()
    got = cuda_ec.scalar_mult_cuda(res, nib, eng)
    torch.cuda.synchronize()
    assert cuda_ec.LAUNCHES == {"ec_scalar_mult": 1}
    plain = ec_rns._scalar_mult(eng, res, nib)
    assert torch.equal(got, plain)
    # The raw-n lane's last add is P + (−P): its Z is exactly 0 in every
    # channel; the raw n + 1 lane ends on G.
    assert not got[2, :, _K5_RAW_N].any()
    assert got[2, :, _K5_RAW_N1].any()
    n_check = min(t, 32)
    decoded = ec_rns.engine("cpu").decode_points(got[:, :, :n_check].cpu().numpy())
    assert decoded == [P256.scalar_mult(p, k) if p is not None else None
                       for p, k in zip(pts[:n_check], ks[:n_check])]


def test_ec_scalar_mult_hosts_strips_on_the_card(dev, monkeypatch):
    """On ``cuda`` the Montgomery strip runs on the card, behind K5: only σ
    is copied off, and no engine on the cpu is built or used."""
    from bftkv_tpu_torch.crypto.ec import P256
    from bftkv_tpu_torch.ops import ec_rns

    seen = []
    real = ec_rns._P256RNS.strip_sigma

    def strip(self, block):
        seen.append((self.device.type, block.device.type))
        return real(self, block)

    monkeypatch.setattr(ec_rns._P256RNS, "strip_sigma", strip)
    monkeypatch.setattr(ec_rns, "_engine_on", functools.lru_cache(maxsize=8)(
        lambda d: pytest.fail("an engine on the cpu was built") if d == "cpu"
        else ec_rns._P256RNS(torch.device(d))))
    g = (P256.gx, P256.gy)
    ks = [0, 1, 2, P256.n - 1, 12345]
    got = ec_rns.scalar_mult_hosts([g] * len(ks), ks, device=dev)
    assert got == [P256.scalar_mult(g, k) for k in ks]
    assert seen == [("cuda", "cuda")]


def test_k5_wrapper_refuses_wrong_operands_on_card(dev):
    from bftkv_tpu_torch.ops import cuda_ec

    eng, res, nib, _pts, _ks = _k5_operands(dev, 8, seed=1)
    cuda_ec.reset_launches()
    bad = [
        (res.to(torch.int64), nib, TypeError),
        (res[:, :-1].contiguous(), nib, ValueError),
        (res, nib[:, :4].contiguous(), ValueError),
        (res[:, :, ::2], nib[:, ::2], ValueError),
        (res, nib.cpu(), ValueError),
    ]
    for r, n, err in bad:
        with pytest.raises(err):
            cuda_ec.scalar_mult_cuda(r, n, eng)
    assert cuda_ec.LAUNCHES == {"ec_scalar_mult": 0}


def test_k5_launch_error_reaches_the_verify_caller(dev, monkeypatch):
    """A refused K5 launch raises out of VerifierDomain.verify_batch: never
    answered by the limb engine or the host, and no staging slot is left
    in flight."""
    from bftkv_tpu_torch.crypto import ecdsa
    from bftkv_tpu_torch.ops import _build, devbuf
    from bftkv_tpu_torch.ops import ec as ec_ops

    lib = _build.library()

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def ec_scalar_mult_launch(*args):
            return 1  # cudaErrorInvalidValue

    key = ecdsa.generate(seed=7)
    items = [(b"m%d" % i, ecdsa.sign(b"m%d" % i, key), key.public) for i in range(30)]
    monkeypatch.setattr(_build, "library", lambda: Refusing())
    monkeypatch.setattr(ecdsa, "verify_host", lambda *a: pytest.fail("host verify reached"))
    monkeypatch.setattr(ec_ops, "scalar_mult_jac", lambda *a: pytest.fail("limb engine reached"))
    with pytest.raises(RuntimeError, match="ec_scalar_mult kernel launch failed"):
        rsa.VerifierDomain(device=dev, host_threshold=0).verify_batch(items)
    assert all(r["in_flight"] == 0 for r in devbuf.stats().values())


def test_ecdsa_batches_on_card_launch_k5_once_each(dev):
    from bftkv_tpu_torch.crypto import ecdsa
    from bftkv_tpu_torch.ops import cuda_ec

    key = ecdsa.generate(seed=8)
    msgs = [b"card %d" % i for i in range(40)]
    cuda_ec.reset_launches()
    sigs = ecdsa.sign_batch(msgs, key, device=dev)
    assert cuda_ec.LAUNCHES == {"ec_scalar_mult": 1}
    assert all(ecdsa.verify_host(m, s, key.public) for m, s in zip(msgs, sigs))
    items = [(m, s, key.public) for m, s in zip(msgs, sigs)]
    items[3] = (msgs[3], sigs[4], key.public)
    assert ecdsa.verify_batch(items, device=dev) == [i != 3 for i in range(40)]
    assert cuda_ec.LAUNCHES == {"ec_scalar_mult": 2}
    attrs = cuda_ec.kernel_attrs()["ec_scalar_mult"]
    assert 0 < attrs["registers"] <= 255 and attrs["points_per_block"] >= 1
