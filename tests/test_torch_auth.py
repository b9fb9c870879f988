"""The port's threshold password authentication (``bftkv_tpu_torch/crypto/
auth.py``) held against the reference's (``bftkv_tpu/crypto/auth.py``).

- The reference's ``tests/test_auth.py`` cases (8), driven by direct calls
  with no transport, against the port on the ``cpu``.
- Cross-package: the port's client against the reference's servers, and
  the reference's client against the port's servers, each round
  recovering the same cipher key as a round within one package.

TPA's group is the fixed 2048-bit RFC 3526 prime, where one batch of the
plain K2 costs seconds on a CPU; every test here keeps both packages'
``BatchModExp`` on host ``pow`` (the card tests run TPA through K2).
"""

from __future__ import annotations

import pytest

from bftkv_tpu import errors as ref_errors
from bftkv_tpu.crypto import auth as ref_auth
from bftkv_tpu.ops import modexp as ref_modexp
from bftkv_tpu_torch.crypto import auth, sss, vcache
from bftkv_tpu_torch.errors import ERR_AUTHENTICATION_FAILURE, ERR_TOO_MANY_ATTEMPTS
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.ops import modexp

DEV = "cpu"


@pytest.fixture(autouse=True)
def _state(monkeypatch):
    vcache.reset()
    metrics.reset()
    monkeypatch.setattr(modexp.BatchModExp, "_shared",
                        {modexp.devmod.resolve(DEV): modexp.BatchModExp(min_batch=10**9, device=DEV)})
    monkeypatch.setattr(ref_modexp.BatchModExp, "_shared", ref_modexp.BatchModExp(min_batch=10**9))
    yield
    vcache.reset()
    metrics.reset()


def run_protocol(password: bytes, servers: dict, n: int, k: int, client=None):
    """Drive all three phases by direct calls — no transport."""
    client = client or auth.AuthClient(password, n, k, device=DEV)
    reqs = client.initiate(list(servers))
    phase = 0
    while not client.done(phase):
        nxt = None
        for nid, req in reqs.items():
            res, _done = servers[nid].make_response(phase, req)
            out = client.process_response(phase, res, nid)
            if out is not None:
                nxt = out
                break
        assert nxt is not None, f"phase {phase} never completed"
        reqs = nxt
        phase += 1
    return client, reqs


def make_servers(password: bytes, n: int, k: int, proofs=None, pkg="port", params=None):
    params = params or auth.generate_partial_auth_params(password, n, k, device=DEV)
    cls = auth.AuthServer if pkg == "port" else ref_auth.AuthServer
    extra = {"device": DEV} if pkg == "port" else {}
    return {
        i: cls(params[i], (proofs[i] if proofs else b"proof-%d" % i), sleep=lambda _t: None, **extra)
        for i in range(n)
    }


def make_refreshed(servers):
    return {
        nid: auth.AuthServer(s.params.serialize(), s.proof, sleep=lambda _t: None, device=DEV)
        for nid, s in servers.items()
    }


def test_full_roundtrip_n10_k7():
    password = b"correct horse battery staple"
    n, k = 10, 7
    servers = make_servers(password, n, k)
    client, proofs = run_protocol(password, servers, n, k)
    for nid, proof in proofs.items():
        assert proof == b"proof-%d" % nid
    key1 = client.get_cipher_key()
    client2, _ = run_protocol(password, make_refreshed(servers), n, k)
    assert client2.get_cipher_key() == key1
    # The key is hash(g_pi^S, password), S from any k servers' shares.
    secret = sss.SSSProcess(n, k, auth.Q, [sss.Coordinate(s.params.x, s.params.y)
                                           for s in list(servers.values())[:k]]).secret
    gs = pow(auth.pi_of(password), secret, auth.P)
    assert key1 == auth._hash(gs.to_bytes((gs.bit_length() + 7) // 8, "big"), password)


def test_wrong_password_fails_mac():
    servers = make_servers(b"right", 4, 3)
    client = auth.AuthClient(b"wrong", 4, 3, device=DEV)
    reqs = client.initiate(list(servers))
    nxt = None
    for nid, req in reqs.items():
        out = client.process_response(0, servers[nid].make_response(0, req)[0], nid)
        if out is not None:
            nxt = out
            break
    assert nxt is not None
    n_map = None
    for nid, req in nxt.items():
        out = client.process_response(1, servers[nid].make_response(1, req)[0], nid)
        if out is not None:
            n_map = out
    assert n_map is not None
    for nid, ni in n_map.items():
        with pytest.raises(ERR_AUTHENTICATION_FAILURE):
            servers[nid].make_response(2, ni)


def test_retry_limit():
    s = make_servers(b"pw", 1, 1)[0]
    x = auth.AuthClient(b"pw", 1, 1, device=DEV).initiate([0])[0]
    for _ in range(auth.AUTH_RETRY_LIMIT - 1):
        s.make_response(0, x)
    with pytest.raises(ERR_TOO_MANY_ATTEMPTS):
        s.make_response(0, x)


def test_k_minus_one_is_insufficient():
    n, k = 5, 3
    servers = make_servers(b"pw", n, k)
    client = auth.AuthClient(b"pw", n, k, device=DEV)
    reqs = client.initiate(list(servers))
    fed = 0
    for nid, req in reqs.items():
        if fed == k - 1:
            break
        assert client.process_response(0, servers[nid].make_response(0, req)[0], nid) is None
        fed += 1
    assert client.gs is None


def test_params_roundtrip():
    p = auth.AuthParams(x=3, y=12345, v=67890, salt=b"salty")
    assert auth.AuthParams.parse(p.serialize()) == p
    assert p.serialize() == ref_auth.AuthParams(x=3, y=12345, v=67890, salt=b"salty").serialize()


def test_stragglers_and_duplicates_ignored():
    n, k = 5, 3
    servers = make_servers(b"pw", n, k)
    client = auth.AuthClient(b"pw", n, k, device=DEV)
    reqs = client.initiate(list(servers))
    nxt = None
    for nid, req in reqs.items():
        out = client.process_response(0, servers[nid].make_response(0, req)[0], nid)
        if out is not None:
            nxt = out
    assert nxt is not None and len(nxt) == k
    n_map = None
    for nid, req in nxt.items():
        res, _ = servers[nid].make_response(1, req)
        out = client.process_response(1, res, nid)
        dup = client.process_response(1, res, nid)
        assert dup is None or out is not None
        n_map = out or n_map
    assert n_map is not None and all(v is not None for v in n_map.values())
    proofs = None
    for nid, ni in n_map.items():
        out = client.process_response(2, servers[nid].make_response(2, ni)[0], nid)
        proofs = out or proofs
    assert proofs is not None
    for nid, proof in proofs.items():
        assert proof == b"proof-%d" % nid


def test_concurrent_sessions_do_not_clobber():
    s = make_servers(b"pw", 1, 1)[0]
    c1 = auth.AuthClient(b"pw", 1, 1, device=DEV)
    c2 = auth.AuthClient(b"pw", 1, 1, device=DEV)
    x1, x2 = c1.initiate([0])[0], c2.initiate([0])[0]
    m1 = c1.process_response(0, s.make_response(0, x1, session=1)[0], 0)
    m2 = c2.process_response(0, s.make_response(0, x2, session=2)[0], 0)
    n1 = c1.process_response(1, s.make_response(1, m1[0], session=1)[0], 0)
    n2 = c2.process_response(1, s.make_response(1, m2[0], session=2)[0], 0)
    p1 = c1.process_response(2, s.make_response(2, n1[0], session=1)[0], 0)
    p2 = c2.process_response(2, s.make_response(2, n2[0], session=2)[0], 0)
    assert p1[0] == b"proof-0" and p2[0] == b"proof-0"


def test_attempt_counter_spans_sessions():
    s = make_servers(b"pw", 1, 1)[0]
    for i in range(auth.AUTH_RETRY_LIMIT - 1):
        s.make_response(0, auth.AuthClient(b"pw", 1, 1, device=DEV).initiate([0])[0], session=i)
    c = auth.AuthClient(b"pw", 1, 1, device=DEV)
    with pytest.raises(ERR_TOO_MANY_ATTEMPTS):
        s.make_response(0, c.initiate([0])[0], session=99)
    s.reset_attempts()
    res, _ = s.make_response(0, c.initiate([0])[0], session=100)
    assert res


# -- cross-package ----------------------------------------------------------------


def test_port_client_against_reference_servers():
    password = b"cross pw"
    n, k = 5, 3
    params = auth.generate_partial_auth_params(password, n, k, device=DEV)
    ref_servers = make_servers(password, n, k, pkg="ref", params=params)
    client, proofs = run_protocol(password, ref_servers, n, k)
    assert all(proof == b"proof-%d" % nid for nid, proof in proofs.items())
    # Against the port's own servers on the same params: the same key.
    port_client, _ = run_protocol(password, make_servers(password, n, k, params=params), n, k)
    assert client.get_cipher_key() == port_client.get_cipher_key()
    # A wrong password fails the reference servers' MAC check.
    bad = auth.AuthClient(b"wrong", n, k, device=DEV)
    with pytest.raises(ref_errors.ERR_AUTHENTICATION_FAILURE):
        run_protocol(password, make_servers(password, n, k, pkg="ref", params=params), n, k, client=bad)


def test_reference_client_against_port_servers():
    password = b"cross pw 2"
    n, k = 5, 3
    params = ref_auth.generate_partial_auth_params(password, n, k)
    port_servers = make_servers(password, n, k, params=params)
    ref_client = ref_auth.AuthClient(password, n, k)
    ref_client, proofs = run_protocol(password, port_servers, n, k, client=ref_client)
    assert all(proof == b"proof-%d" % nid for nid, proof in proofs.items())
    port_client, _ = run_protocol(password, make_servers(password, n, k, params=params), n, k)
    assert ref_client.get_cipher_key() == port_client.get_cipher_key()


def test_the_engine_is_the_callers_device():
    client = auth.AuthClient(b"pw", 3, 2, device=DEV)
    server = make_servers(b"pw", 1, 1)[0]
    assert client.device.type == server.device.type == "cpu"
    assert modexp.BatchModExp.shared(client.device).min_batch == 10**9  # the fixture's engine
