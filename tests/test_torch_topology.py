"""The port's topology builder (``bftkv_tpu_torch/topology.py``) against
the reference's.

- ``build_universe`` and its sharded, regioned, gateway and
  ``alg="mixed"`` variants give the same structure in both packages:
  names, addresses, uids, regions, and per principal the same view (who
  signed whom) and the same local trust.  Keys are random in the
  reference, so structure is compared by name, not by id.
- A home saved by one package loads in the other: the same graph, the
  same quorums, and a working ``Crypto`` (the port's on ``device="cpu"``):
  shares issued from the loaded homes combine into a collective signature
  that both packages' quorums accept.
- ``make_node`` wires the same graph and quorums as the reference's.
Exact everywhere.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

from bftkv_tpu import topology as ref_topology
from bftkv_tpu.crypto import cert as ref_cert
from bftkv_tpu.crypto import signature as ref_signature
from bftkv_tpu_torch import quorum as q
from bftkv_tpu_torch import regions as rg
from bftkv_tpu_torch import topology
from bftkv_tpu_torch.crypto import cert as certmod
from bftkv_tpu_torch.crypto import ecdsa, rsa

VARIANTS = {
    "plain": dict(n_servers=4, n_users=1, n_rw=2),
    "sharded": dict(n_servers=4, n_users=2, n_rw=2, n_shards=2),
    "regioned": dict(n_servers=4, n_users=2, n_rw=2, n_regions=3, n_gateways=1),
    "mixed": dict(n_servers=4, n_users=2, n_rw=1, alg="mixed", unsigned_users=1),
    "trust_rw": dict(n_servers=7, n_users=1, n_rw=3, server_trust_rw=True),
}


def _algs(n_servers=4, n_users=1, n_rw=0, n_shards=1, n_gateways=0, alg="rsa", **_):
    """The key algorithm of each principal in ``build_universe``'s order."""
    def alg_for(i):
        if alg == "mixed":
            return certmod.ALG_P256 if i % 2 else certmod.ALG_RSA
        return alg

    return ([alg_for(i) for _ in range(n_shards) for i in range(n_servers)]
            + [alg_for(i) for i in range(n_rw * n_shards)]
            + [alg_for(i) for i in range(n_users)]
            + [alg_for(i) for i in range(n_gateways)])


def _seeded_keys(algs, bits=512, base=9000):
    return [ecdsa.generate(seed=base + i) if a == certmod.ALG_P256 else rsa.generate(bits, seed=base + i)
            for i, a in enumerate(algs)]


@functools.lru_cache(maxsize=None)
def _port_universe(variant, bits=512):
    kw = VARIANTS[variant]
    return topology.build_universe(**kw, bits=bits, keys=_seeded_keys(_algs(**kw), bits))


def _structure(uni, view_of, local_trust_of):
    name = {i.id: i.name for i in uni.all}
    out = {
        "principals": [(i.name, i.cert.address, i.cert.uid, i.region, i.cert.alg) for i in uni.all],
        "shards": [[i.name for i in g] for g in uni.shards],
        "cert_signers": sorted(name[i] for i in uni.cert_signer_ids),
        "gateway_addrs": uni.gateway_addrs,
        "regions": uni.regions,
        "server_trust_rw": uni.server_trust_rw,
    }
    for ident in uni.all:
        view = view_of(ident)
        out[ident.name] = (
            sorted((name[c.id], sorted(name.get(s, "?") for s in c.signers())) for c in view),
            sorted(name[i] for i in local_trust_of(ident)),
        )
    return out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_build_universe_has_the_references_structure(variant):
    mine = _port_universe(variant)
    theirs = ref_topology.build_universe(**VARIANTS[variant], bits=1024)
    assert _structure(mine, mine.view_of, mine.local_trust_of) == _structure(
        theirs, theirs.view_of, theirs.local_trust_of)


def test_views_cross_parse_and_keys_are_used_in_order():
    uni = _port_universe("mixed")
    algs = _algs(**VARIANTS["mixed"])
    assert [i.cert.alg for i in uni.all] == algs
    for ident in uni.all:
        blob = certmod.serialize_many(uni.view_of(ident))
        assert ref_cert.serialize_many(ref_cert.parse(blob)) == blob
        # Every signature in the view verifies in the reference.
        by_id = {c.id: c for c in ref_cert.parse(blob)}
        for c in by_id.values():
            for s in c.signers():
                if s in by_id:
                    assert ref_cert.verify_detached(c.tbs(), c.signatures[s], by_id[s])


def _same_graph(g1, g2):
    assert g1.get_self_id() == g2.get_self_id()
    assert sorted(g1.vertices) == sorted(g2.vertices)
    for vid in g1.vertices:
        assert sorted(g1.vertices[vid].edges) == sorted(g2.vertices[vid].edges), vid


def _same_quorums(qs1, qs2):
    for rw in (q.AUTH, q.AUTH | q.PEER, q.CERT | q.AUTH, q.READ | q.AUTH, q.WRITE):
        m1, i1 = qs1.choose_quorum(rw).membership_matrix()
        m2, i2 = qs2.choose_quorum(rw).membership_matrix()
        assert i1 == i2
        np.testing.assert_array_equal(m1, m2)
        b1, b2 = qs1.choose_quorum(rw).bounds(), qs2.choose_quorum(rw).bounds()
        for k in b1:
            np.testing.assert_array_equal(b1[k], b2[k])


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_homes_load_in_the_other_package(tmp_path, writer):
    rg.clear()
    uni = _port_universe("trust_rw")
    save = topology.save_home if writer == "port" else ref_topology.save_home
    for ident in uni.all:
        save(str(tmp_path / ident.name), ident, uni.view_of(ident),
             local_trust=uni.local_trust_of(ident), regions=uni.regions)
    loaded = {i.name: (topology.load_home(str(tmp_path / i.name), device="cpu"),
                       ref_topology.load_home(str(tmp_path / i.name))) for i in uni.all}
    for name, ((g1, c1, qs1), (g2, c2, qs2)) in loaded.items():
        _same_graph(g1, g2)
        _same_quorums(qs1, qs2)
        assert c1.signer.cert.id == c2.signer.cert.id
        assert sorted(c.id for c in c1.keyring.certs()) == sorted(c.id for c in c2.keyring.certs())
    # A working crypto bundle: the servers' shares over one tbs combine in
    # the user's bundle into a collective signature that both packages'
    # AUTH|PEER quorums accept, and that f + 1 shares do not satisfy.
    user = uni.users[0].name
    (_, crypt, qs), (_, ref_crypt, ref_qs) = loaded[user]
    quorum, ref_quorum = qs.choose_quorum(q.AUTH | q.PEER), ref_qs.choose_quorum(q.AUTH | q.PEER)
    tbs = b"tbs of one write"
    ss = None
    sufficient = []
    for ident in uni.servers:
        share = loaded[ident.name][0][1].signer.issue(tbs)
        ss, ok = crypt.collective.combine(ss, share, quorum, crypt.keyring)
        sufficient.append(ok)
    f = (len(uni.servers) - 1) // 3
    assert sufficient[f] is False and sufficient[-1] is True
    crypt.collective.verify(tbs, ss, quorum, crypt.keyring, use_cache=False)
    ref_crypt.collective.verify(tbs, ref_signature.SignaturePacket(
        type=ss.type, version=ss.version, completed=ss.completed, data=ss.data, cert=ss.cert),
        ref_quorum, ref_crypt.keyring, use_cache=False)
    with pytest.raises(Exception):
        crypt.collective.verify(b"another tbs", ss, quorum, crypt.keyring, use_cache=False)
    rg.clear()


def test_make_node_wires_the_references_node():
    uni = _port_universe("trust_rw")
    for ident in uni.servers[:1] + uni.storage_nodes[:1] + uni.users:
        view = uni.view_of(ident)
        g1, c1, qs1 = topology.make_node(ident, view, uni.local_trust_of(ident), device="cpu")
        ref_view = ref_cert.parse(certmod.serialize_many(view))
        ref_ident = ref_topology.Identity(ident.name, ident.key, next(c for c in ref_view if c.id == ident.id))
        g2, c2, qs2 = ref_topology.make_node(ref_ident, ref_view, uni.local_trust_of(ident))
        _same_graph(g1, g2)
        _same_quorums(qs1, qs2)
        assert sorted(c.id for c in c1.keyring.certs()) == sorted(c.id for c in c2.keyring.certs())
        assert c1.collective.verifier.device.type == "cpu"


def test_writers_quorum_is_the_server_clique():
    """The headline's view at a small width: every user's AUTH|PEER
    quorum is the whole server clique with the b-masking bounds, and
    WRITE adds the storage nodes ("W = U - {Ci} + R")."""
    uni = topology.build_universe(7, 2, 2, bits=512,
                                  keys=_seeded_keys(_algs(7, 2, 2), base=9500))
    servers = {s.id for s in uni.servers}
    from bftkv_tpu_torch.quorum.wotqs import bmasking_params

    for ident in uni.users + uni.servers:
        _, _, qs = topology.make_node(ident, uni.view_of(ident), device="cpu")
        for rw in (q.AUTH, q.AUTH | q.PEER):
            qr = qs.choose_quorum_for(b"x", rw)
            _, index = qr.membership_matrix()
            want = servers - ({ident.id} if rw & q.PEER else set())
            if ident in uni.servers and rw & q.PEER:
                continue  # a server's PEER clique is one smaller
            assert set(index) == want
            b = qr.bounds()
            f, min_, th, suff = bmasking_params(len(want))
            assert (int(b["f"][0]), int(b["min"][0]), int(b["threshold"][0]), int(b["suff"][0])) == (
                f, min_, th, suff)
        if ident in uni.users:
            # The addressed members of the write quorum: the clique and
            # every storage node.
            w = qs.choose_quorum(q.WRITE | q.AUTH)
            assert {n.id for n in w.nodes()} == servers | {s.id for s in uni.storage_nodes}
