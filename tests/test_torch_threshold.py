"""The port's threshold signing (``bftkv_tpu_torch/crypto/threshold``: k-of-n
RSA, and the dealerless DSA/ECDSA core with its two group plugins) held
against the reference's (``bftkv_tpu/crypto/threshold``).

- The reference's ``tests/test_threshold.py`` cases (10), simulated
  multi-node without transport, against the port on the ``cpu``.
- Cross-package: for each scheme a deal and client of one package with
  the servers of the other, both ways; the combined signature verifies
  under the other package (RSA, ECDSA) or the host DSA equation.
- The device seam, one test per engine: a 1024-bit threshold-DSA
  ``calculate_r`` through ``BatchModExp(device="cpu")`` on the plain K2,
  and threshold ECDSA end to end through the plain K5 (the RNS engine),
  each against host ``pow`` and the host curve.

Every other test keeps ``BatchModExp`` on host ``pow`` (a batch below its
``min_batch``) and threshold ECDSA on the host curve, so the plain
kernels run only where a test is about them.
"""

from __future__ import annotations

import hashlib
import itertools
import random

import pytest

from bftkv_tpu import errors as ref_errors
from bftkv_tpu.crypto import cert as ref_cert
from bftkv_tpu.crypto import ec as ref_ec
from bftkv_tpu.crypto import ecdsa as ref_ecdsa
from bftkv_tpu.crypto import new_crypto as ref_new_crypto
from bftkv_tpu.crypto import rsa as ref_rsa
from bftkv_tpu.crypto.threshold import dsa as ref_tdsa
from bftkv_tpu.crypto.threshold import ecdsa as ref_tecdsa
from bftkv_tpu.crypto.threshold import rsa as ref_trsa
from bftkv_tpu.ops import modexp as ref_modexp
from bftkv_tpu_torch import errors
from bftkv_tpu_torch.crypto import cert as certmod
from bftkv_tpu_torch.crypto import ec, ecdsa, new_crypto, vcache
from bftkv_tpu_torch.crypto import rsa as rsakeys
from bftkv_tpu_torch.crypto.threshold import (
    ThresholdAlgo,
    ThresholdInstance,
    parse_params,
    serialize_params,
)
from bftkv_tpu_torch.crypto.threshold import dsa as tdsa
from bftkv_tpu_torch.crypto.threshold import ecdsa as tecdsa
from bftkv_tpu_torch.crypto.threshold import rsa as trsa
from bftkv_tpu_torch.crypto.threshold.dsa_core import PartialR
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.ops import cuda_rns, modexp

DEV = "cpu"
RNG = random.Random(42)


def _rng(bound):
    return RNG.randrange(bound)


@pytest.fixture(autouse=True)
def _fresh_state():
    vcache.reset()
    metrics.reset()
    yield
    vcache.reset()
    metrics.reset()


@pytest.fixture
def host_modexp(monkeypatch):
    """Both packages' shared modexp engines on host ``pow``: every batch
    is below ``min_batch``."""
    monkeypatch.setattr(modexp.BatchModExp, "_shared",
                        {modexp.devmod.resolve(DEV): modexp.BatchModExp(min_batch=10**9, device=DEV)})
    monkeypatch.setattr(ref_modexp.BatchModExp, "_shared", ref_modexp.BatchModExp(min_batch=10**9))


@pytest.fixture
def host_curve(monkeypatch):
    """Threshold ECDSA of both packages on the host curve."""
    monkeypatch.setattr(tecdsa._ECDSAGroupOps, "_device_capable", lambda self: False)
    monkeypatch.setattr(ref_tecdsa._ECDSAGroupOps, "_device_capable", lambda self: False)


@pytest.fixture(scope="module")
def rsa_key():
    return rsakeys.generate(1024, seed=9001)


@pytest.fixture(scope="module")
def dsa_key():
    return tdsa.generate(1024, seed=9002)


class FakeNode:
    def __init__(self, i):
        self.id = i


# -- RSA tree unit tests (the reference's rsa_test.go:31-102 cases) -----------


def test_split_key_sums_back():
    d = RNG.getrandbits(512)
    frags = trsa._split_key(d, 7, _rng)
    assert sum(frags) == d and len(frags) == 7


def test_key_tree_covers_k_subsets():
    n, k = 5, 3
    d = RNG.getrandbits(64)
    tree = trsa.make_key_tree(d, 0, n, k, _rng)
    per_server = []
    for i in range(n):
        keys = {}
        trsa.collect_keys(tree, i, keys)
        per_server.append(keys)
        assert keys, f"server {i} holds no fragments"

    def recover(node, holders):
        if node.children is None:
            return None
        total = 0
        for i, child in node.children.items():
            if i in holders:
                assert per_server[i][node.idx] == child.di
                total += child.di
            else:
                sub = recover(child, holders)
                if sub is None:
                    return None
                total += sub
        return total

    for subset in itertools.combinations(range(n), k):
        assert recover(tree, set(subset)) == d, subset
    for subset in itertools.combinations(range(n), k - 1):
        assert recover(tree, set(subset)) is None, subset


def _drive_rsa(proc, sign_of, subset):
    """Client rounds: the process's requests to ``subset``'s servers."""
    for _round in range(10):
        target, req = proc.make_request()
        if req is None:
            break
        for node in target:
            if node.id not in subset:
                continue
            res = sign_of(node.id, req)
            if res is not None and proc.process_response(res, node) is not None:
                return proc.sig
    return proc.sig


def sim_rsa_sign(key, n, k, subset, tbs=b"threshold me"):
    ctx = trsa.RSAThreshold(rng=_rng, device=DEV)
    nodes = [FakeNode(i) for i in range(n)]
    shares, algo = ctx.distribute(key, nodes, k)
    assert algo == ThresholdAlgo.RSA
    proc = ctx.new_process(tbs, algo, "sha256")
    sig = _drive_rsa(proc, lambda i, req: ctx.sign(shares[i], req, 0xC11E47, i), subset)
    return sig, tbs


def test_rsa_threshold_full_quorum(rsa_key, host_modexp):
    sig, tbs = sim_rsa_sign(rsa_key, 5, 3, set(range(5)))
    assert sig is not None
    assert rsakeys.verify_host(tbs, sig, rsa_key.public)
    assert sig == rsakeys.sign(tbs, rsa_key)


def test_rsa_threshold_k_subsets(rsa_key, host_modexp):
    for subset in [set(s) for s in [(0, 1, 2), (2, 3, 4), (0, 2, 4), (1, 3, 4)]]:
        sig, tbs = sim_rsa_sign(rsa_key, 5, 3, subset)
        assert sig is not None, f"subset {subset} failed"
        assert rsakeys.verify_host(tbs, sig, rsa_key.public), subset


def test_rsa_threshold_k_minus_one_insufficient(rsa_key, host_modexp):
    sig, _ = sim_rsa_sign(rsa_key, 5, 3, {0, 1})
    assert sig is None


def test_emsa_matches_host_encoding(rsa_key):
    prefix = trsa._HASH_PREFIXES["sha256"]
    m = trsa.emsa_encode(prefix, hashlib.sha256(b"encode me").digest(), rsa_key.size_bytes)
    assert m == rsakeys.emsa_pkcs1v15_sha256(b"encode me", rsa_key.size_bytes)


# -- DSA/ECDSA 3-phase simulation (the reference's dsa_test.go:221-463) -------


_UNIVERSE: dict[int, list] = {}


def _identities(n):
    """n server identities (1024-bit RSA, self-signed), seeded and cached."""
    if n not in _UNIVERSE:
        out = []
        for i in range(n):
            key = rsakeys.generate(1024, seed=9100 + 10 * n + i)
            c = certmod.Certificate(n=key.n, name=f"s{i}", address=f"addr{i}", uid=f"u{i}")
            certmod.sign_certificate(c, key)
            out.append((key, c))
        _UNIVERSE[n] = out
    return _UNIVERSE[n]


def make_universe(n, package="port"):
    """The identities' crypto bundles, each with every cert in its keyring."""
    idents = _identities(n)
    if package == "ref":
        idents = [(ref_rsa.PrivateKey(n=k.n, e=k.e, d=k.d, p=k.p, q=k.q), ref_cert.parse(c.serialize())[0])
                  for k, c in idents]
    bundles = []
    for key, c in idents:
        crypt = new_crypto(key, c, device=DEV) if package == "port" else ref_new_crypto(key, c)
        for _, other in idents:
            crypt.keyring.register([other])
        bundles.append(crypt)
    return idents, bundles


def sim_dsa_sign(client_new, key, n, kthresh, tbs=b"dsa sign me", client_pkg="port",
                 servers_by_pkg=None):
    """The deal and the client from ``client_pkg``; server i from
    ``servers_by_pkg[i % len]``, a (package, context factory) pair (the
    same identities in both packages; default: the client's)."""
    servers_by_pkg = servers_by_pkg or [(client_pkg, client_new)]
    c_idents, c_bundles = make_universe(n, client_pkg)
    bundles = {pkg: make_universe(n, pkg)[1] for pkg, _new in servers_by_pkg}
    servers = {}
    for i, (_, c) in enumerate(c_idents):
        pkg, new = servers_by_pkg[i % len(servers_by_pkg)]
        servers[c.id] = new(bundles[pkg][i])
    c_nodes = [c for _, c in c_idents]
    client_ctx = client_new(c_bundles[0])
    out, algo = client_ctx.distribute(key, c_nodes, kthresh)
    shares = {node.id: share for node, share in zip(c_nodes, out)}
    cont = (errors.ERR_CONTINUE, ref_errors.ERR_CONTINUE)
    proc = client_ctx.new_process(tbs, algo, "sha256")
    for _round in range(10):
        target, req = proc.make_request()
        if not target:
            break
        advance = False
        for node in target:
            res = servers[node.id].sign(shares[node.id], req, 0xBEEF, node.id)
            if res is None:
                continue
            try:
                result = proc.process_response(res, node)
            except cont:
                advance = True
                break
            if result is not None:
                return result
        if not advance:
            break
    return None


def _dsa_verify(key, sig, tbs):
    size = (key.q.bit_length() + 7) // 8
    r, s = int.from_bytes(sig[:size], "big"), int.from_bytes(sig[size:], "big")
    assert 0 < r < key.q and 0 < s < key.q
    m = tdsa._DSAGroupOps(key.p, key.q, key.g, DEV).os2i(hashlib.sha256(tbs).digest())
    w = pow(s, -1, key.q)
    v = pow(key.g, m * w % key.q, key.p) * pow(key.y, r * w % key.q, key.p) % key.p % key.q
    return v == r


def test_dsa_threshold_roundtrip(dsa_key, host_modexp):
    new = lambda crypt: tdsa.new(crypt, device=DEV)
    sig = sim_dsa_sign(new, dsa_key, 6, 3)
    assert sig is not None
    assert _dsa_verify(dsa_key, sig, b"dsa sign me")


def _ec_public(key):
    x, y = key.curve.scalar_base_mult(key.d)
    return ecdsa.ECPublicKey(x=x, y=y)


def test_ecdsa_threshold_roundtrip_through_the_plain_k5(monkeypatch):
    """The device seam of threshold ECDSA: every partial R (one K5 launch
    at T=8 each) and the combine (one launch) on the RNS engine's plain
    K5; the signature passes the host verify."""
    monkeypatch.setenv("BFTKV_EC_BACKEND", "rns")
    from bftkv_tpu_torch.ops import ec_rns

    calls = []
    real = ec_rns.scalar_mult_hosts
    monkeypatch.setattr(ec_rns, "scalar_mult_hosts",
                        lambda pts, ks, device=None: calls.append(len(pts)) or real(pts, ks, device=device))
    key = tecdsa.generate(ec.P256, seed=9003)
    tbs = b"ecdsa sign me"
    new = lambda crypt: tecdsa.new(crypt, device=DEV)
    sig = sim_dsa_sign(new, key, 6, 3, tbs=tbs)
    assert sig is not None
    assert ecdsa.verify_host(tbs, sig, _ec_public(key))
    assert calls == [1] * 6 + [6]  # six partial R, then the combine


def test_dispatcher_routes_by_key_and_algo(rsa_key):
    idents, bundles = make_universe(3)
    nodes = [c for _, c in idents]
    inst = ThresholdInstance(bundles[0], device=DEV)
    shares, algo = inst.distribute(rsa_key, nodes, 2)
    assert algo == ThresholdAlgo.RSA
    back_algo, data = parse_params(serialize_params(algo, shares[0]))
    assert back_algo == ThresholdAlgo.RSA and data == shares[0]
    with pytest.raises(errors.ERR_UNSUPPORTED_ALGORITHM):
        inst.distribute(object(), nodes, 2)
    with pytest.raises(errors.ERR_UNSUPPORTED_ALGORITHM):
        parse_params(b"")


def test_partial_param_hostile_bytes():
    rng = random.Random(9004)
    for data in [b"", b"\x00", b"\xff" * 7, rng.randbytes(40)]:
        with pytest.raises(errors.Error):
            trsa._parse_partial_param(data)
        with pytest.raises(errors.Error):
            trsa._parse_sign_request(data)
        with pytest.raises(errors.Error):
            trsa._parse_partial_signature(data)


# -- cross-package ----------------------------------------------------------------


@pytest.mark.parametrize("client_pkg", ["port", "ref"])
def test_rsa_threshold_crosses_the_packages(rsa_key, client_pkg, host_modexp):
    """The deal and the client of one package, the servers of the other;
    the signature verifies under the servers' package."""
    rkey = ref_rsa.PrivateKey(n=rsa_key.n, e=rsa_key.e, d=rsa_key.d, p=rsa_key.p, q=rsa_key.q)
    port_ctx = trsa.RSAThreshold(rng=_rng, device=DEV)
    ref_ctx = ref_trsa.RSAThreshold(rng=_rng)
    client, server = (port_ctx, ref_ctx) if client_pkg == "port" else (ref_ctx, port_ctx)
    nodes = [FakeNode(i) for i in range(5)]
    shares, algo = client.distribute(rsa_key if client_pkg == "port" else rkey, nodes, 3)
    tbs = b"cross " + client_pkg.encode()
    proc = client.new_process(tbs, algo, "sha256")
    sig = _drive_rsa(proc, lambda i, req: server.sign(shares[i], req, 0xC11E47, i), {0, 2, 4})
    assert sig is not None
    verify = ref_rsa.verify_host if client_pkg == "port" else rsakeys.verify_host
    assert verify(tbs, sig, (rkey if client_pkg == "port" else rsa_key).public)
    assert sig == rsakeys.sign(tbs, rsa_key)


def _mixed(port_new, ref_new):
    return [("port", port_new), ("ref", ref_new)]


@pytest.mark.parametrize("client_pkg", ["port", "ref"])
def test_dsa_threshold_crosses_the_packages(dsa_key, client_pkg, host_modexp):
    """Shares dealt and combined by one package, the three phases served by
    both packages' servers in turn: each server decrypts joint shares that
    servers of both packages sealed to it."""
    port_new = lambda crypt: tdsa.new(crypt, device=DEV)
    ref_key = ref_tdsa.DSAPrivateKey(p=dsa_key.p, q=dsa_key.q, g=dsa_key.g, x=dsa_key.x, y=dsa_key.y)
    client_new, key = (port_new, dsa_key) if client_pkg == "port" else (ref_tdsa.new, ref_key)
    sig = sim_dsa_sign(client_new, key, 6, 3, client_pkg=client_pkg,
                       servers_by_pkg=_mixed(port_new, ref_tdsa.new))
    assert sig is not None
    assert _dsa_verify(dsa_key, sig, b"dsa sign me")


@pytest.mark.parametrize("client_pkg", ["port", "ref"])
def test_ecdsa_threshold_crosses_the_packages(client_pkg, host_curve, host_modexp):
    key = tecdsa.generate(ec.P256, seed=9005)
    ref_key = ref_tecdsa.ECDSAPrivateKey(ref_ec.P256, key.d)
    tbs = b"ecdsa cross " + client_pkg.encode()
    port_new = lambda crypt: tecdsa.new(crypt, device=DEV)
    client_new, ckey = (port_new, key) if client_pkg == "port" else (ref_tecdsa.new, ref_key)
    sig = sim_dsa_sign(client_new, ckey, 6, 3, tbs=tbs, client_pkg=client_pkg,
                       servers_by_pkg=_mixed(port_new, ref_tecdsa.new))
    assert sig is not None
    x, y = ref_ec.P256.scalar_base_mult(key.d)
    assert ref_ecdsa.verify_host(tbs, sig, ref_ecdsa.ECPublicKey(x=x, y=y))
    assert ecdsa.verify_host(tbs, sig, _ec_public(key))


# -- the device seam ----------------------------------------------------------------


def test_dsa_calculate_r_through_the_plain_k2(dsa_key, monkeypatch):
    """``BatchModExp(device="cpu")`` at its default ``min_batch``: the
    Lagrange exponentiations of a 1024-bit ``calculate_r`` ride one launch
    of K2's plain version (k=94) and equal host ``pow``."""
    monkeypatch.setattr(modexp.BatchModExp, "_shared", {})
    ops = tdsa._DSAGroupOps(dsa_key.p, dsa_key.q, dsa_key.g, DEV)
    assert ops._engine is modexp.BatchModExp.shared(DEV) and ops._engine.min_batch == 4
    rng = random.Random(9006)
    rs = []
    for x in (1, 3, 4, 6):
        a = rng.randrange(1, dsa_key.q)
        ri = pow(dsa_key.g, a, dsa_key.p)
        rs.append(PartialR(x, ri.to_bytes((ri.bit_length() + 7) // 8, "big"), rng.randrange(1, dsa_key.q)))
    calls = []
    real = modexp.rns.power_mod_rns
    monkeypatch.setattr(modexp.rns, "power_mod_rns",
                        lambda *a, **k: calls.append((len(a[0]), k["n_bits"])) or real(*a, **k))
    cuda_rns.reset_launches()
    r = ops.calculate_r(rs)
    assert calls == [(4, 1024)]
    assert metrics.snapshot().get("modexp.rns_staged") == 4
    assert cuda_rns.LAUNCHES["pow"] == 0  # the plain version, not the kernel
    xs = [pr.x for pr in rs]
    from bftkv_tpu_torch.crypto import sss

    lams = [sss.lagrange(pr.x, xs, dsa_key.q) for pr in rs]
    prod = 1
    for pr, lam in zip(rs, lams):
        prod = prod * pow(int.from_bytes(pr.ri, "big"), lam, dsa_key.p) % dsa_key.p
    v = sum(pr.vi * lam for pr, lam in zip(rs, lams)) % dsa_key.q
    assert r == pow(prod, pow(v, -1, dsa_key.q), dsa_key.p) % dsa_key.q


def test_threshold_rsa_2048_fragments_outgrow_the_device_path(monkeypatch):
    """At 2048 bits a (3, 4) deal holds fragments of 4090-8181 bits, past
    the RNS context and, at the widest, past ``MAX_EXP_LIMBS``; a server's
    few fragments a request sign with host ``pow``: no launch, no limb
    batch."""
    key = rsakeys.generate(2048, seed=9007)
    ctx = trsa.RSAThreshold(rng=random.Random(9008).randrange, device=DEV)
    nodes = [FakeNode(i) for i in range(4)]
    shares, _algo = ctx.distribute(key, nodes, 3)
    widths = [abs(f).bit_length() for s in shares for f in trsa._parse_partial_param(s)[0].values()]
    # Fragments of 4090-8181 bits: past the 2048-bit RNS context, and the
    # widest past the limb path's exponent cap.
    assert min(widths) > 4000
    assert modexp.limb.nlimbs_for_bits(max(widths)) > modexp.BatchModExp.MAX_EXP_LIMBS
    calls = []
    monkeypatch.setattr(modexp.rns, "power_mod_rns", lambda *a, **k: calls.append("rns"))
    monkeypatch.setattr(modexp.rsa_ops, "power_batch", lambda *a, **k: calls.append("limb"))
    proc = ctx.new_process(b"wide", ThresholdAlgo.RSA, "sha256")
    sig = _drive_rsa(proc, lambda i, req: ctx.sign(shares[i], req, 1, i), {0, 1, 3})
    assert calls == []
    assert sig == rsakeys.sign(b"wide", key)


def test_shared_engine_is_one_per_device():
    a = modexp.BatchModExp.shared("cpu")
    assert modexp.BatchModExp.shared(modexp.devmod.resolve("cpu")) is a
    assert a.device.type == "cpu"
