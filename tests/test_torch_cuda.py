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
from bftkv_tpu_torch.tools.time_rns import EC_RAW_N, EC_RAW_N1, ec_operands, mont_operands
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


def _k5_operands(dev, t: int, seed: int):
    """Staged K5 operands at T = t (``time_rns.ec_operands``): the edge lanes
    (identities, scalars 0, 1, 2, n − 1, the raw windows of n and n + 1)
    in the first group of 8 points, then seeded points and scalars."""
    return ec_operands(t, seed, dev)


@pytest.mark.parametrize("t", [8, 13, 256, 2048])
def test_k5_matches_plain_on_card(dev, t):
    from bftkv_tpu_torch.crypto.ec import P256
    from bftkv_tpu_torch.ops import cuda_ec, ec_rns

    eng, res, nib, pts, ks = _k5_operands(dev, t, seed=t)
    assert EC_RAW_N1 < 8  # the edge lanes share K5's first group
    cuda_ec.reset_launches()
    got = cuda_ec.scalar_mult_cuda(res, nib, eng)
    torch.cuda.synchronize()
    assert cuda_ec.LAUNCHES == {"ec_scalar_mult": 1}
    plain = ec_rns._scalar_mult(eng, res, nib)
    assert torch.equal(got, plain)
    # The raw-n lane's last add is P + (−P): its Z is exactly 0 in every
    # channel; the raw n + 1 lane ends on G.
    assert not got[2, :, EC_RAW_N].any()
    assert got[2, :, EC_RAW_N1].any()
    n_check = min(t, 32)
    decoded = ec_rns.engine("cpu").decode_points(got[:, :, :n_check].cpu().numpy())
    assert decoded == [P256.scalar_mult(p, k) if p is not None else None
                       for p, k in zip(pts[:n_check], ks[:n_check])]
    # Nothing at or past T is written: the block's last row ends the live
    # words of a buffer filled with a sentinel (T=13: the last group holds
    # 5 points and 3 slots past T).
    sentinel = -0x5A5A5A5B
    buf = torch.full((res.numel() + 64,), sentinel, dtype=torch.int32, device=dev)
    cuda_ec._launch(res, nib, eng, buf[: res.numel()].view(res.shape))
    torch.cuda.synchronize()
    assert torch.equal(buf[: res.numel()].view(res.shape), plain)
    assert (buf[res.numel():] == sentinel).all()
    assert cuda_ec.LAUNCHES == {"ec_scalar_mult": 2}


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
    assert 0 < attrs["registers"] <= 255 and attrs["points_per_block"] == 8
    assert attrs["local_bytes"] == 0 and attrs["blocks_per_sm"] >= 1


# -- the sidecar and the split (M10, M11) ----------------------------------------


@pytest.fixture
def card_sidecar(dev, tmp_path, monkeypatch):
    """The port's sidecar on a Unix socket on the card, its crossover pinned
    at 16 items (every frame below reaches the kernels), and one channel."""
    from bftkv_tpu_torch.cmd import verify_sidecar as vs
    from bftkv_tpu_torch.crypto.remote_verify import SidecarChannel
    from bftkv_tpu_torch.ops import dispatch

    monkeypatch.setenv("BFTKV_DISPATCH_RECAL_S", "0")
    addr = f"unix:{tmp_path}/card.sock"
    srv, _t = vs.serve(addr, max_wait=0.01, device=dev)
    monkeypatch.setenv("BFTKV_DISPATCH_CROSSOVER", "16")
    srv.service.recalibrate()
    chan = SidecarChannel(addr)
    yield srv, chan
    chan.close()
    srv.service.stop()
    srv.shutdown()
    srv.server_close()
    monkeypatch.delenv("BFTKV_DISPATCH_CROSSOVER")
    dispatch.calibration(force=True, device=dev)


def test_sidecar_on_card_answers_verify_sign_and_modexp_frames(dev, card_sidecar):
    """VERIFY, REGISTER + SIGN and MODEXP frames answered from the card: K1
    and K2 launched, every answer equal to the host's."""
    import io
    import struct

    from bftkv_tpu_torch.cmd import verify_sidecar as vs
    from bftkv_tpu_torch.packet import read_chunk

    srv, chan = card_sidecar
    key = rsa.generate(2048, seed=81)
    items = [(b"card-sc-%d" % i, rsa.sign(b"card-sc-%d" % i, key), key.public) for i in range(32)]
    items[5] = (items[5][0], items[6][1], key.public)
    cuda_rns.reset_launches()
    metrics.reset()
    st, body = chan.request(vs.OP_VERIFY, vs.encode_request(items))
    assert st == vs.ST_OK and body == bytes(i != 5 for i in range(32))
    assert cuda_rns.LAUNCHES["verify"] == 1
    st, body = chan.request(vs.OP_REGISTER, vs.encode_register_request([key]))
    assert st == vs.ST_OK and struct.unpack(">II", body) == (1, 1)
    msgs = [b"card-share-%d" % i for i in range(16)]
    st, body = chan.request(vs.OP_SIGN, vs.encode_sign_request([(1, m) for m in msgs]))
    r = io.BytesIO(body)
    assert st == vs.ST_OK and [read_chunk(r) for _ in msgs] == [rsa.sign(m, key) for m in msgs]
    assert cuda_rns.LAUNCHES["pow"] == 1
    rng = random.Random(82)
    mx = [(rng.getrandbits(2048), rng.getrandbits(2048), key.n) for _ in range(16)]
    st, body = chan.request(vs.OP_MODEXP, vs.encode_modexp_request(mx))
    r = io.BytesIO(body)
    assert st == vs.ST_OK
    assert [int.from_bytes(read_chunk(r), "big") for _ in mx] == [pow(*it) for it in mx]
    assert cuda_rns.LAUNCHES["pow"] == 2
    snap = metrics.snapshot()
    assert snap["verify.device"] == 32 and snap["sign.device"] == 16 and snap["modexp.device"] == 16
    assert not any(snap.get(k) for k in ("verify.host", "sign.host", "modexp.host"))


def test_k2_error_inside_the_sidecar_reaches_the_tenant_as_err(dev, card_sidecar, monkeypatch):
    """A refused K2 launch inside the sidecar: the frame gets ST_ERR and the
    sidecar answers nothing from its own host crypto; the tenant's domain
    falls back to local pow and opens its breaker."""
    from bftkv_tpu_torch.cmd import verify_sidecar as vs
    from bftkv_tpu_torch.crypto.remote_verify import RemoteModexpDomain
    from bftkv_tpu_torch.ops import _build, devbuf

    srv, chan = card_sidecar
    lib = _build.library()

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def rns_pow_launch(*args):
            return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(_build, "library", lambda: Refusing())
    n = rsa.generate(2048, seed=83).n
    rng = random.Random(84)
    mx = [(rng.getrandbits(2048), rng.getrandbits(2048), n) for _ in range(16)]
    metrics.reset()
    st, body = chan.request(vs.OP_MODEXP, vs.encode_modexp_request(mx))
    assert st == vs.ST_ERR and body == b""
    md = RemoteModexpDomain(channel=chan, spot_rate=0.0)
    assert md.powmod_batch(mx) == [pow(*it) for it in mx]
    snap = metrics.snapshot()
    assert snap["modexp.remote_fallback"] == 16 and chan.tripped()
    assert not snap.get("modexp.host") and not snap.get("modexp.device")
    assert all(r["in_flight"] == 0 for r in devbuf.stats().values())


def test_split_over_two_shards_of_one_card_equals_unsplit(dev):
    """The verify and the sign modexp split over ["cuda:0", "cuda:0"] (two
    streams of one card): bit-identical to the unsplit launch, one launch a
    shard."""
    ctx = rns.context()
    ns = _moduli(ctx, 2048, 3, seed=85)
    rng = random.Random(86)
    idx = [rng.randrange(3) for _ in range(300)]
    sigs = [rng.randrange(ns[i]) for i in idx]
    ems = [pow(s, 65537, ns[i]) if j % 3 else rng.randrange(ns[i]) for j, (s, i) in enumerate(zip(sigs, idx))]
    urows = [ctx.key_rows(n) for n in ns]
    mods = _moduli(rns.context(64, 1024), 1024, 4, seed=87)
    bases = [rng.getrandbits(1024) for _ in range(100)]
    exps = [rng.getrandbits(1024) for _ in range(100)]
    mods = [mods[i % 4] for i in range(100)]
    cuda_rns.reset_launches()
    v0 = rns.verify_e65537_rns_indexed(sigs, ems, idx, urows, device=dev)
    p0 = rns.power_mod_rns(bases, exps, mods, device=dev)
    assert cuda_rns.LAUNCHES == {"verify": 1, "pow": 1}
    with rns.shard_over([dev, dev]):
        v = rns.verify_e65537_rns_indexed(sigs, ems, idx, urows, device=dev)
        d = rns.power_mod_rns(bases, exps, mods, device=dev, defer=True)
        assert len(d.events) == 2
        p = d.wait()
    assert cuda_rns.LAUNCHES == {"verify": 3, "pow": 3}
    np.testing.assert_array_equal(v, v0)
    np.testing.assert_array_equal(v0, [j % 3 != 0 for j in range(300)])
    assert p == p0 == [pow(b, e, m) for b, e, m in zip(bases, exps, mods)]


def test_kernels_launch_on_their_tensors_card(dev):
    """K1 and K2 on operands on cuda:1, launched from a thread whose current
    card is cuda:0: the wrappers make the operands' card current, so the
    shared-memory attribute and the launch land on cuda:1."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev1 = torch.device("cuda", 1)
    a1, want = _k1_operands(dev1, 64, 2, seed=88)
    ctx = rns.context(64, 1024)
    ns = _moduli(ctx, 1024, 2, seed=89)
    rng = random.Random(90)
    bases = [rng.getrandbits(1024) for _ in range(40)]
    exps = [rng.getrandbits(1024) for _ in range(40)]
    mods = [ns[i % 2] for i in range(40)]
    with torch.cuda.device(0):
        got = cuda_rns.verify_cuda(*a1)
        torch.cuda.synchronize(dev1)
        assert got.device == dev1 and got.cpu().tolist() == want
        assert rns.power_mod_rns(bases, exps, mods, device=dev1) == [
            pow(b, e, m) for b, e, m in zip(bases, exps, mods)]
        assert torch.cuda.current_device() == 0


def test_tallies_on_card_equal_the_cpu(dev):
    """The tallies on the card (a float32 product, where CUDA may use TF32)
    equal the CPU's, which tests/test_torch_tally.py holds against the
    reference's jits."""
    from bftkv_tpu_torch.ops import tally

    rng = np.random.default_rng(91)
    membership = rng.random((9, 300)) < 0.4
    candidates = rng.random((2000, 300)) < 0.5
    f = rng.integers(-1, 60, size=9).astype(np.int32)
    min_ = rng.integers(0, 120, size=9).astype(np.int32)
    got = tally.counts(membership, candidates, device=dev)
    assert got.device == dev and got.dtype == torch.int32
    assert torch.equal(got.cpu(), tally.counts(membership, candidates, device="cpu"))
    for name, args in (("is_threshold_batch", (min_,)), ("is_quorum_batch", (f, min_)),
                       ("is_sufficient_batch", (min_,)), ("reject_batch", (f,))):
        mine = getattr(tally, name)(membership, candidates, *args, device=dev)
        assert torch.equal(mine.cpu(), getattr(tally, name)(membership, candidates, *args,
                                                            device="cpu"))
    signer_sets = rng.random((5, 300)) < 0.3
    assert torch.equal(tally.equivocation_pairs(signer_sets, device=dev).cpu(),
                       tally.equivocation_pairs(signer_sets, device="cpu"))


# -- the crypto layer (M12a) ----------------------------------------------------------


def _recording(monkeypatch, module, name):
    """Keeps a copy of the operands of every call of ``module.name``."""
    calls = []
    real = getattr(module, name)

    def rec(*args):
        calls.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return real(*args)

    monkeypatch.setattr(module, name, rec)
    return calls


def test_tpa_round_on_card_holds_each_k2_launch_against_plain(dev, monkeypatch):
    """A TPA round (n=8, k=5) on the card: the params and the client's two
    batched exponentiations are K2 launches at k=188, each equal to its
    plain version; the proofs decrypt and the cipher key is hash(g_pi^S,
    password) for the S the servers share."""
    from bftkv_tpu_torch.crypto import auth, sss

    monkeypatch.setattr(modexp.BatchModExp, "_shared", {})
    calls = _recording(monkeypatch, cuda_rns, "pow_cuda")
    cuda_rns.reset_launches()
    pw, n, k = b"card pw", 8, 5
    params = auth.generate_partial_auth_params(pw, n, k, device=dev)
    servers = {i: auth.AuthServer(params[i], b"proof-%d" % i, sleep=lambda _t: None, device=dev)
               for i in range(n)}
    client = auth.AuthClient(pw, n, k, device=dev)
    reqs = client.initiate(list(servers))
    for phase in range(3):
        nxt = None
        for nid, req in reqs.items():
            nxt = client.process_response(phase, servers[nid].make_response(phase, req)[0], nid)
            if nxt is not None:
                break
        reqs = nxt
    assert reqs == {nid: b"proof-%d" % nid for nid in reqs} and len(reqs) == k
    secret = sss.SSSProcess(n, k, auth.Q, [sss.Coordinate(s.params.x, s.params.y)
                                           for s in list(servers.values())[:k]]).secret
    gs = pow(auth.pi_of(pw), secret, auth.P)
    assert client.get_cipher_key() == auth._hash(gs.to_bytes((gs.bit_length() + 7) // 8, "big"), pw)
    assert cuda_rns.LAUNCHES["pow"] == len(calls) == 3
    for a in list(calls):
        assert a[4].k == 188
        plain = rns._pow_kernel(a[4], a[0], a[1], rns.gather_key(a[3], a[2]))
        assert torch.equal(cuda_rns.pow_cuda(*a).long(), plain.long())


def test_threshold_ecdsa_combine_on_card_holds_each_k5_launch_against_plain(dev, monkeypatch):
    """Threshold ECDSA's group operations on the card: each partial R
    (a_i·G, one K5 launch at T=8) and the combine (Σ(v⁻¹λ_i)·R_i, one
    launch) equal the host curve, and every launch equals its plain
    version."""
    from bftkv_tpu_torch.crypto import ec, sss
    from bftkv_tpu_torch.crypto.threshold import ecdsa as tecdsa
    from bftkv_tpu_torch.crypto.threshold.dsa_core import PartialR
    from bftkv_tpu_torch.ops import cuda_ec, ec_rns

    calls = _recording(monkeypatch, cuda_ec, "scalar_mult_cuda")
    cuda_ec.reset_launches()
    ops = tecdsa._ECDSAGroupOps(ec.P256, dev)
    rng = random.Random(61)
    n_order = ec.P256.n
    rs, a_s = [], []
    for x in (1, 2, 4, 5, 7, 9):
        a = rng.randrange(1, n_order)
        a_s.append(a)
        ri = ops.calculate_partial_r(a)
        assert ec.unmarshal(ec.P256, ri) == ec.P256.scalar_base_mult(a)
        rs.append(PartialR(x, ri, rng.randrange(1, n_order)))
    r = ops.calculate_r(rs)
    xs = [pr.x for pr in rs]
    lams = [sss.lagrange(x, xs, n_order) for x in xs]
    v_inv = pow(sum(pr.vi * lam for pr, lam in zip(rs, lams)) % n_order, -1, n_order)
    acc = None
    for a, lam in zip(a_s, lams):
        acc = ec.P256.add(acc, ec.P256.scalar_base_mult(a * lam * v_inv % n_order))
    assert r == acc[0] % n_order
    assert cuda_ec.LAUNCHES["ec_scalar_mult"] == len(calls) == len(rs) + 1
    assert [a[0].shape[-1] for a in calls] == [8] * len(rs) + [8]
    for res, nib, eng in list(calls):
        assert torch.equal(cuda_ec.scalar_mult_cuda(res, nib, eng), ec_rns._scalar_mult(eng, res, nib))


def test_port_cluster_on_card_writes_and_reads_through_the_dispatchers(dev):
    """A 4+4 loopback cluster of port servers and a port client, every node
    on the card, writes 64 items with ``write_many`` and reads them back
    through the installed dispatchers: the servers' writer-signature
    batches and the client's ``verify_many`` launch K1, the servers'
    shares K2 (and K1's fault checks); the fan-out is threaded."""
    from bftkv_tpu_torch import transport
    from bftkv_tpu_torch.ops import dispatch
    from test_torch_utils import start_cluster

    dispatch.install(dispatch.VerifyDispatcher(rsa.VerifierDomain(device=dev, host_threshold=0),
                                               max_batch=4096, calibrate=False))
    dispatch.install_signer(dispatch.SignDispatcher(rsa.SignerDomain(device=dev, host_threshold=0),
                                                    max_batch=4096, calibrate=False))
    c = start_cluster(4, 1, 4, bits=2048, device=dev, key_base=7000)
    try:
        cl = c.clients[0]
        assert cl.device == dev and all(s.device == dev for s in c.all_servers)
        assert not transport._inline_fanout_ok()
        items = [(b"card/%d" % i, b"value-%d" % i) for i in range(64)]
        cuda_rns.reset_launches()
        assert cl.write_many(items) == [None] * 64
        cl.drain_tails()
        assert cl.read_many([v for v, _ in items]) == [v for _, v in items]
        assert cuda_rns.LAUNCHES["verify"] >= 1 and cuda_rns.LAUNCHES["pow"] >= 1, cuda_rns.LAUNCHES
    finally:
        dispatch.uninstall_all()
        c.stop()


# -- the operator surfaces on the card ---------------------------------------


def _card_fleet(tmp_path, key_base: int, extra_env=None, dispatch: bool = False, **spawn_kw):
    """A 4 + 4 fleet of daemon processes on localhost HTTP from seeded
    2048-bit homes, every daemon on ``cuda:0``: with ``dispatch`` each
    started as ``python -m bftkv_tpu_torch.cmd.bftkv --dispatch``, else by
    ``run_cluster.spawn(**spawn_kw)``; returns (homes dir, processes, API
    ports, environment, python)."""
    import os
    import socket
    import subprocess
    import sys
    import time

    from bftkv_tpu_torch.cmd import genkeys, run_cluster
    from test_torch_utils import build_universe, free_port_block

    uni = build_universe(4, 1, 4, bits=2048, transport="http", key_base=key_base)
    keys = str(tmp_path / "keys")
    genkeys.write_homes(uni, keys)
    api = free_port_block(8)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {"PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", ""), **(extra_env or {})}
    homes, dbs, logs = run_cluster.server_homes(keys), tmp_path / "dbs", tmp_path / "logs"
    if dispatch:
        dbs.mkdir()
        logs.mkdir()
        procs = []
        for i, home in enumerate(homes):
            name = os.path.basename(home)
            with open(logs / f"{name}.log", "ab") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "bftkv_tpu_torch.cmd.bftkv", "--home", home,
                     "--db", str(dbs / name), "--storage", "mem", "--revlist", str(dbs / f"{name}.rev"),
                     "--api", f"127.0.0.1:{api + i}", "--device", "cuda:0", "--dispatch"],
                    env=dict(os.environ, **env), stdout=out, stderr=subprocess.STDOUT))
    else:
        procs = run_cluster.spawn(homes, str(dbs), storage="mem", api_base=api, extra_env=env,
                                  device="cuda:0", log_dir=str(logs), **spawn_kw)
    ports = [int(i.cert.address.rsplit(":", 1)[1]) for i in uni.servers + uni.storage_nodes]
    deadline = time.monotonic() + 240
    for port in ports + [api + i for i in range(8)]:
        while True:
            with socket.socket() as s:
                s.settimeout(0.5)
                if s.connect_ex(("127.0.0.1", port)) == 0:
                    break
            assert all(p.poll() is None for p in procs), "a daemon exited at start"
            assert time.monotonic() < deadline, f"port {port} never came up"
            time.sleep(0.25)
    return keys, procs, [api + i for i in range(8)], dict(os.environ, **env), sys.executable


def _bftrw_write_read(keys, env, python):
    import os
    import subprocess

    home = os.path.join(keys, "u01")
    lines = "".join(f"card/{i}=value-{i}\n" for i in range(64)).encode()
    base = [python, "-m", "bftkv_tpu_torch.cmd.bftrw", "--home", home, "--device", "cuda:0"]
    w = subprocess.run(base + ["writemany"], input=lines, env=env, capture_output=True, timeout=300)
    assert w.returncode == 0 and b"64/64 written" in w.stderr, w.stderr[-2000:]
    r = subprocess.run(base + ["readmany"] + [f"card/{i}" for i in range(64)], env=env,
                       capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.decode().splitlines() == [f"card/{i}=value-{i}" for i in range(64)]


def _card_pids() -> set:
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout
    return {int(x) for x in out.split() if x.strip().isdigit()}


def _metrics(ports) -> list:
    import json
    import urllib.request

    out = []
    for port in ports:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics?format=json", timeout=60) as res:
            out.append(json.loads(res.read()))
    return out


def test_dispatch_fleet_claims_the_card_and_reads_back_what_bftrw_wrote(dev, tmp_path):
    """A 4 + 4 fleet of daemons started with ``--dispatch`` on ``cuda:0``: every
    daemon claims the card (CUDA initialised, by its ``/metrics``), their
    batches run on the card (``verify.device`` and ``sign.device``, host
    thresholds 0), and ``bftrw`` (``--device cuda:0``) reads back its
    ``writemany``."""
    from bftkv_tpu_torch.cmd import run_cluster

    keys, procs, apis, env, python = _card_fleet(
        tmp_path, 7200, {"BFTKV_HOST_VERIFY_THRESHOLD": "0", "BFTKV_HOST_SIGN_THRESHOLD": "0"},
        dispatch=True)
    try:
        _bftrw_write_read(keys, env, python)
        ms = _metrics(apis)
        assert [m["device.cuda_initialized"] for m in ms] == [1] * 8
        assert sum(m.get("verify.device", 0) for m in ms) > 0
        assert sum(m.get("sign.device", 0) for m in ms) > 0
    finally:
        run_cluster.shutdown(procs)
    assert [p.returncode for p in procs] == [0] * 8


def test_sidecar_fleet_daemons_hold_no_card_context(dev, tmp_path):
    """``run_cluster`` with ``--sidecar auto`` on ``cuda:0``: the spawned
    sidecar owns the card, the 8 daemons (``--device cuda:0``) create no
    CUDA context, none falls back to local crypto, and ``bftrw`` reads back
    its ``writemany`` through them; every daemon exits 0."""
    from bftkv_tpu_torch.cmd import run_cluster

    # The sidecar's admission sized for its 8 tenants (its defaults serve 4
    # batches at once and shed after 0.5 s in the queue); a batch waits
    # less than the tenants' 30 s channel timeout.
    admission = {"BFTKV_SIDECAR_MAX_INFLIGHT": "64", "BFTKV_SIDECAR_MAX_QUEUE": "256",
                 "BFTKV_SIDECAR_MAX_WAIT": "20"}
    keys, procs, apis, env, python = _card_fleet(tmp_path, 7300, admission, sidecar="auto")
    try:
        _bftrw_write_read(keys, env, python)
        daemons = {p.pid for p in procs if "bftkv_tpu_torch.cmd.bftkv" in p.args}
        sidecar = {p.pid for p in procs} - daemons
        assert len(daemons) == 8 and len(sidecar) == 1
        # By each daemon's own account, and by the NVIDIA driver's where it shows
        # this namespace's pids.
        ms = _metrics(apis)
        assert [m["device.cuda_initialized"] for m in ms] == [0] * 8
        assert not daemons & set(_card_pids())
        assert sum(m.get("sign.remote", 0) for m in ms) > 0 and sum(m.get("verify.remote", 0) for m in ms) > 0
        assert sum(m.get("verify.remote_fallback", 0) + m.get("sign.remote_fallback", 0) for m in ms) == 0
    finally:
        run_cluster.shutdown(procs)
    assert all(p.returncode == 0 for p in procs if "bftkv_tpu_torch.cmd.bftkv" in p.args)


# -- the health plane and the chaos nemesis on the card ------------------------


def test_nemesis_seed_7_on_the_card_launches_k1(dev, monkeypatch, capsys):
    """``nemesis --seed 7 --steps 2 --bits 2048 --device cuda:0``: the
    chaos cluster's nodes verify on the card (host thresholds 0, so every
    collective and writer-signature verify batch launches K1; the verify
    memo off, since in one process every node's own signature is seeded
    into the one shared memo) and the run exits 0 with K1 launched and
    counted."""
    from bftkv_tpu_torch.crypto import vcache
    from bftkv_tpu_torch.faults import nemesis
    from bftkv_tpu_torch.faults import failpoint as fp

    monkeypatch.setenv("BFTKV_HOST_VERIFY_THRESHOLD", "0")
    monkeypatch.setenv("BFTKV_HOST_SIGN_THRESHOLD", "0")
    monkeypatch.setattr(vcache, "_ENABLED", False)
    cuda_rns.reset_launches()
    try:
        rc = nemesis.main(["--seed", "7", "--steps", "2", "--bits", "2048", "--device", "cuda:0"])
    finally:
        fp.disarm()
    out = capsys.readouterr().out
    assert rc == 0, out[-3000:]
    assert "nemesis: ok" in out
    assert cuda_rns.LAUNCHES["verify"] >= 1, cuda_rns.LAUNCHES


def test_fleet_cli_against_a_sidecar_fleet_holds_no_card_context(dev, tmp_path):
    """``cmd.fleet --scrapes 1`` against a ``--sidecar auto`` fleet on
    ``cuda:0``: the one-shot sees the 8 daemons and the sidecar up, exits
    0, and its process never initialises CUDA (it does not even import
    torch)."""
    import json
    import subprocess

    from bftkv_tpu_torch.cmd import run_cluster

    admission = {"BFTKV_SIDECAR_MAX_INFLIGHT": "64", "BFTKV_SIDECAR_MAX_QUEUE": "256",
                 "BFTKV_SIDECAR_MAX_WAIT": "20"}
    keys, procs, apis, env, python = _card_fleet(tmp_path, 7400, admission, sidecar="auto")
    try:
        _bftrw_write_read(keys, env, python)
        code = ("import json, sys\n"
                "from bftkv_tpu_torch.cmd import fleet\n"
                "rc = fleet.main(sys.argv[1:])\n"
                "t = sys.modules.get('torch')\n"
                "print(json.dumps({'torch': t is not None,"
                " 'cuda': bool(t is not None and t.cuda.is_initialized())}))\n"
                "sys.exit(rc)\n")
        r = subprocess.run([python, "-c", code, "--api-base", str(apis[0]), "--count", "9",
                            "--scrapes", "1", "--json"], env=env, capture_output=True, timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        text = r.stdout.decode()
        doc = json.loads(text[: text.rindex("\n{")])
        state = json.loads(text[text.rindex("\n{"):])
        assert doc["fleet"]["up"] == 9 and doc["sidecars"]["sidecar01"]["status"] == "up"
        assert doc["sidecars"]["sidecar01"]["device_plane"]["device"] == "cuda:0"
        assert state == {"torch": False, "cuda": False}
    finally:
        run_cluster.shutdown(procs)
