"""The port's staging against the JAX package's.

``power_mod_rns`` of both packages runs on the same seeded inputs, with
the reference's ``_jitted_pow`` stubbed as ``tests/test_device_plane.py``
stubs it (no JAX compile): the arrays the reference's ``_pow_staging``
slot hands its kernel (``base_halves``, ``nib_t``, ``idx``, the stacked
key rows) must equal the tensors the port stages for K2, padding rows
included.  The verify rows the port writes as little-endian bytes must
equal the reference's ``int_to_limbs`` → ``digits_to_halves_u8`` route,
and the staged ``pallas`` operands the limb domain's ``assemble``.
Verdicts and signatures through the dispatchers equal host ``pow`` /
signing on the plain kernels.
"""

from __future__ import annotations

import random
import threading

import numpy as np
import pytest
import torch

from bftkv_tpu.ops import limb as ref_limb
from bftkv_tpu.ops import rns as ref_rns
from bftkv_tpu_torch.crypto import rsa
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.ops import cuda_mont, cuda_rns, devbuf, dispatch, rns
from test_torch_utils import moduli, one_torch_thread  # noqa: F401  (fixture)


def _sigma(ctx, v: int) -> list[int]:
    return [(v % p) * pow((ctx.M // p) % p, -1, p) % p for p in ctx.pb]


def _crt_int(ctx, residues) -> int:
    m = 0
    for r, p in zip(residues, ctx.pb):
        mi = ctx.M // p
        m += ((int(r) * pow(mi % p, -1, p)) % p) * mi
    return m % ctx.M


def _answer(ctx, bh, nt, ix, n_all) -> np.ndarray:
    """σ of base^exp mod n per staged row, from host ``pow``."""
    k = ctx.k
    mods = [_crt_int(ctx, row[:k]) for row in np.asarray(n_all).tolist()]
    out = np.empty((bh.shape[0], k), dtype=np.int64)
    for j in range(bh.shape[0]):
        b = int.from_bytes(np.asarray(bh[j], dtype=np.uint8).tobytes(), "little")
        e = 0
        for nib in np.asarray(nt[:, j]).tolist():
            e = (e << 4) | int(nib)
        out[j] = _sigma(ctx, pow(b, e, mods[int(ix[j])]))
    return out


@pytest.fixture()
def staged(monkeypatch):
    """Both packages' K2 stubbed; each records the operands it was handed."""
    got: dict = {"ref": [], "port": []}

    def ref_jitted(digits, n_bits, donate=False):
        ctx = ref_rns.context(digits, n_bits)

        def g(bh, nt, ix, ukey):
            rec = [np.array(a) for a in (bh, nt, ix)] + [np.asarray(u).copy() for u in ukey]
            got["ref"].append(rec)
            return _answer(ctx, rec[0], rec[1], rec[2], rec[3]).astype(np.float32)

        return g

    def port_pow(base_h, nib_t, idx, ukey, cn):
        rec = [a.numpy().copy() for a in (base_h, nib_t, idx, *ukey)]
        got["port"].append(rec)
        ctx = rns.context(cn.digits, 16 * cn.digits)
        return torch.from_numpy(_answer(ctx, rec[0], rec[1], rec[2], rec[3]))

    monkeypatch.setattr(ref_rns, "_jitted_pow", ref_jitted)
    monkeypatch.setattr(ref_rns, "_shardable", lambda _batch: False)
    monkeypatch.setattr(cuda_rns, "pow_cuda", port_pow)
    devbuf.reset()
    yield got
    devbuf.reset()


@pytest.mark.parametrize("n_bits,t,n_mods", [(512, 37, 3), (512, 64, 1), (2048, 5, 2)])
def test_pow_staging_equals_the_reference_slot(staged, n_bits, t, n_mods):
    rng = random.Random(n_bits * 1000 + t)
    mods_u = moduli(rns.context(max(32, n_bits // 16), n_bits), n_bits, n_mods, seed=n_bits + t)
    mods = [mods_u[i % n_mods] for i in range(t)]
    bases = [rng.getrandbits(n_bits + 40) for _ in range(t)]  # wider than m: reduced
    exps = [rng.getrandbits(rng.randrange(1, n_bits + 1)) for _ in range(t)]
    exps[0] = 0
    want = [pow(b, e, m) for b, e, m in zip(bases, exps, mods)]
    assert ref_rns.power_mod_rns(bases, exps, mods, n_bits=n_bits) == want
    assert rns.power_mod_rns(bases, exps, mods, n_bits=n_bits, device="cpu") == want
    (ref,), (port,) = staged["ref"], staged["port"]
    names = ("base_halves", "nib_t", "idx") + rns.KEY_ROWS
    assert len(ref) == len(port) == len(names)
    for name, a, b in zip(names, ref, port):
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64), err_msg=name)
    assert port[0].shape[0] == max(64, 1 << (t - 1).bit_length())


def test_deferred_pow_releases_its_slot_only_at_wait(staged):
    mods = moduli(rns.context(32, 512), 512, 1, seed=5) * 3
    d = rns.power_mod_rns([2, 3, 4], [5, 6, 7], mods, n_bits=512, defer=True, device="cpu")
    assert [r["in_flight"] for r in devbuf.stats().values()] == [1]
    assert d.event is None  # the CPU has no event to wait on
    assert d.wait() == [pow(b, e, m) for b, e, m in zip([2, 3, 4], [5, 6, 7], mods)]
    assert [r["in_flight"] for r in devbuf.stats().values()] == [0]


def test_byte_rows_equal_the_int_to_limbs_route():
    rng = random.Random(1234)
    n = moduli(rns.context(), 2048, 1, seed=9)[0]
    vals = [0, 1, n - 1, n, n + 1, (1 << 2048) - 1]  # s >= n stays encodable
    vals += [rng.getrandbits(rng.randrange(1, 2049)) for _ in range(200 - len(vals))]
    want = ref_rns.digits_to_halves_u8(np.stack([ref_limb.int_to_limbs(v, 128) for v in vals]))
    np.testing.assert_array_equal(rns.bytes_rows(vals, 256), want)
    # The 16-bit digits of the pallas rows are the same bytes, two by two.
    np.testing.assert_array_equal(
        rns.bytes_rows(vals, 256).view("<u2"),
        np.stack([ref_limb.int_to_limbs(v, 128) for v in vals]),
    )


@pytest.fixture(scope="module")
def keys():
    return [rsa.generate(1024, seed=s) for s in (20, 21, 22)]


def _items(keys, n: int, seed: int):
    """Seeded verify items: valid, forged, s >= n, and a hostile modulus."""
    rng = random.Random(seed)
    items, want = [], []
    hostile = rsa.PublicKey(n=rns.context().pb[0] * ((1 << 1013) + 1))
    for i in range(n):
        key = keys[i % len(keys)]
        msg = b"staged-%d-%d" % (seed, i)
        sig = rsa.sign(msg, key)
        kind = rng.randrange(8)
        pub = key.public
        if kind == 0:
            sig = sig[:-1] + bytes([sig[-1] ^ 1])
        elif kind == 1:
            sig = (key.n + rng.randrange(1 << 100)).to_bytes(128, "big")
        elif kind == 2:
            pub = hostile
        items.append((msg, sig, pub))
        want.append(rsa.verify_host(msg, sig, pub))
    return items, want


def test_verify_rows_are_staged_by_bytes_and_s_ge_n_stays_on_host(keys, monkeypatch):
    """The rns verify flush stages each device item's s and em as bytes,
    pads with s = 0 against row 0's em and key, and keeps s >= n and
    hostile moduli on the host."""
    seen = []

    def fake_verify(sig_h, em_h, idx, ukey, cn):
        seen.append([a.numpy().copy() for a in (sig_h, em_h, idx, ukey[0])])
        ctx = rns.context()
        mods = [_crt_int(ctx, row[: cn.k]) for row in ukey[0].tolist()]
        return torch.tensor([
            pow(int.from_bytes(bytes(s.tolist()), "little"), 65537, mods[int(i)])
            == int.from_bytes(bytes(e.tolist()), "little")
            for s, e, i in zip(sig_h, em_h, idx)
        ])

    monkeypatch.setattr(cuda_rns, "verify_cuda", fake_verify)
    devbuf.reset()
    metrics.reset()
    items, want = _items(keys, 40, seed=3)
    dom = rsa.VerifierDomain(device="cpu", host_threshold=0)
    np.testing.assert_array_equal(dom.verify_batch(items), want)
    ((sh, eh, ix, n_all),) = seen
    dev = [
        (m, s, k) for m, s, k in items
        if rns.context().key_rows(k.n) is not None and int.from_bytes(s, "big") < k.n
    ]
    t = len(dev)
    snap = metrics.snapshot()
    assert snap["verify.device"] == t and snap["verify.host"] == len(items) - t
    sig_ints = [int.from_bytes(s, "big") for _m, s, _k in dev]
    em_ints = [rsa.emsa_pkcs1v15_sha256(m, k.size_bytes) for m, _s, k in dev]
    halves = lambda xs: ref_rns.digits_to_halves_u8(
        np.stack([ref_limb.int_to_limbs(x, 128) for x in xs]))
    assert sh.shape == (256, 256)
    np.testing.assert_array_equal(sh[:t], halves(sig_ints))
    np.testing.assert_array_equal(eh[:t], halves(em_ints))
    assert not sh[t:].any() and (eh[t:] == eh[0]).all() and not ix[t:].any()
    assert n_all.shape[0] == 64 and (n_all[len(keys):] == n_all[0]).all()
    assert all(r["in_flight"] == 0 for r in devbuf.stats().values())
    devbuf.reset()


def test_pallas_operands_are_staged_as_assemble_builds_them(keys, monkeypatch):
    seen = []

    def fake_k3(sig, em, n, nprime, r2):
        seen.append([a.numpy().copy() for a in (sig, em, n, nprime, r2)])
        return torch.ones(sig.shape[0], dtype=torch.bool)

    monkeypatch.setattr(cuda_mont, "verify_cuda", fake_k3)
    devbuf.reset()
    items = [it for it in _items(keys, 40, seed=4)[0] if it[2].n in {k.n for k in keys}]
    dom = rsa.VerifierDomain(device="cpu", host_threshold=0, backend="pallas")
    dom.verify_batch(items)
    ((staged),) = seen
    k = len(items)
    want = dom.assemble(items)  # the route the limb backend keeps
    for j, (a, w) in enumerate(zip(staged, want)):
        np.testing.assert_array_equal(a[:k], w.astype(np.int64))
        pad = np.zeros_like(w[0]) if j == 0 else w[0]
        assert (a[k:] == pad).all()
    assert all(r["in_flight"] == 0 for r in devbuf.stats().values())
    devbuf.reset()


@pytest.mark.usefixtures("one_torch_thread")
def test_pipelined_dispatchers_on_plain_kernels_match_host(keys):
    """Two flush workers each (pipeline 2), plain K1 and K2: verdicts equal
    host pow and signatures host signing."""
    devbuf.reset()
    metrics.reset()
    vd = dispatch.VerifyDispatcher(
        rsa.VerifierDomain(device="cpu", host_threshold=0),
        max_batch=64, max_wait=0.02, pipeline=2, calibrate=False,
    ).start()
    sd = dispatch.SignDispatcher(
        rsa.SignerDomain(device="cpu", host_threshold=0),
        max_batch=8, max_wait=0.02, pipeline=2, calibrate=False,
    ).start()
    assert vd.pipeline == 2 and len(vd._pool.workers) == 2
    results: dict = {}
    try:
        def verifier(t):
            items, want = _items(keys, 12, seed=100 + t)
            results[("v", t)] = (vd.verify(items), want)

        def signer(t):
            key = keys[t % len(keys)]
            msgs = [b"pipelined-%d-%d" % (t, j) for j in range(2)]
            results[("s", t)] = (sd.submit([(m, key) for m in msgs]),
                                 [rsa.sign(m, key) for m in msgs])

        threads = [threading.Thread(target=verifier, args=(t,)) for t in range(3)]
        threads += [threading.Thread(target=signer, args=(t,)) for t in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        assert not any(th.is_alive() for th in threads)
    finally:
        vd.stop()
        sd.stop()
    assert len(results) == 5
    for got, want in results.values():
        assert list(got) == list(want)
    snap = metrics.snapshot()
    assert snap["verify.device"] > 0 and snap["sign.device"] == 4
    assert "sign.fault" not in snap
    assert all(r["in_flight"] == 0 for r in devbuf.stats().values())
    devbuf.reset()
