"""The port's client facade (``api.py``) against the reference's cases
(``tests/test_api.py``, reference: api/api_test.go:48-162) on a port
cluster on the cpu, and homes written by either package's ``topology``
opened by the port's ``open_client``."""

from __future__ import annotations

import pytest

from bftkv_tpu_torch import api as apimod
from bftkv_tpu_torch import topology
from bftkv_tpu_torch.errors import Error
from bftkv_tpu_torch.ops import modexp
from bftkv_tpu_torch.transport.loopback import TrLoopback

from test_torch_utils import BITS, DEVICE, seeded_key, start_cluster


@pytest.fixture(autouse=True)
def _host_modexp(monkeypatch):
    """The TPA modexps on host ``pow`` (the plain K2 batch of the 2048-bit
    TPA group takes seconds on a CPU)."""
    monkeypatch.setattr(modexp.BatchModExp, "_shared",
                        {modexp.devmod.resolve(DEVICE): modexp.BatchModExp(min_batch=10**9, device=DEVICE)})


@pytest.fixture(scope="module")
def cluster():
    c = start_cluster(n_servers=4, n_users=1, n_rw=4)
    yield c
    c.stop()


def _open(cluster, home, **kw):
    factory = lambda crypt: TrLoopback(crypt, cluster.net)
    return apimod.open_client(home, factory, join=False, device=DEVICE, **kw)


def test_register_enrolls_a_virgin_user(cluster, tmp_path):
    """A fresh identity with zero counter-signatures registers, gains a
    quorum certificate, and can then write (reference: api_test.go:48-140)."""
    uni = cluster.universe
    homes = {}
    for ident in uni.servers + uni.storage_nodes:
        homes[ident.name] = str(tmp_path / ident.name)
        topology.save_home(homes[ident.name], ident, uni.view_of(ident))
    virgin = topology.new_identity("test1", uid="test1@example.com", key=seeded_key(BITS, 980))
    homes["test1"] = str(tmp_path / "test1")
    topology.save_home(homes["test1"], virgin, [virgin.cert])
    api = _open(cluster, homes["test1"])

    api._sign_peers([homes[s.name] for s in uni.servers])
    with pytest.raises(Error):
        api.client.write(b"api_prereg", b"x")

    api.register([homes[i.name] for i in uni.servers + uni.storage_nodes], "s3cret")
    self_cert = api.crypt.keyring.lookup(api.graph.id)
    assert len(self_cert.signers()) >= 3  # self + >= f+1 servers

    api.write(b"api_postreg", b"registered!")
    assert api.read(b"api_postreg") == b"registered!"


def test_password_protected_write_read(cluster, tmp_path):
    uni = cluster.universe
    user = uni.users[0]
    d = str(tmp_path / "u01-home")
    topology.save_home(d, user, uni.view_of(user))
    api = _open(cluster, d)

    api.write(b"api_pw_var", b"top secret", password="hunter2")
    assert api.read(b"api_pw_var", password="hunter2") == b"top secret"
    raw = api.client.read(b"api_pw_var", api.client.authenticate(b"api_pw_var", b"hunter2")[0])
    assert raw != b"top secret"
    with pytest.raises(Error):
        api.read(b"api_pw_var", password="wrong")


def test_update_cert_rewrites_pubring(cluster, tmp_path):
    uni = cluster.universe
    user = uni.users[0]
    d = str(tmp_path / "u01-home")
    topology.save_home(d, user, uni.view_of(user))
    api = _open(cluster, d)
    api.update_cert()
    graph, crypt, qs = topology.load_home(d, device=DEVICE)
    assert graph.id == user.id
    assert len(graph.get_peers()) >= len(uni.servers)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_open_client_reads_a_home_of_either_package(cluster, tmp_path, writer):
    """A user home written by the port's or the reference's ``topology``
    (the same identity, re-parsed in the writing package) opens in the
    port's ``open_client`` and does a write, a read, a ``write_many`` and
    a ``read_many`` that read back."""
    uni = cluster.universe
    user = uni.users[0]
    d = str(tmp_path / "home")
    if writer == "port":
        topology.save_home(d, user, uni.view_of(user))
    else:
        from bftkv_tpu import topology as ref_topology
        from bftkv_tpu.crypto import cert as ref_cert
        from bftkv_tpu.crypto import rsa as ref_rsa

        view = ref_cert.parse(b"".join(c.serialize() for c in uni.view_of(user)))
        me = next(c for c in view if c.id == user.id)
        key = ref_rsa.PrivateKey(n=user.key.n, e=user.key.e, d=user.key.d,
                                 p=user.key.p, q=user.key.q)
        ref_topology.save_home(d, ref_topology.Identity(name=user.name, key=key, cert=me), view)
    api = _open(cluster, d)
    assert api.client.device.type == "cpu"
    api.write(b"home/%s" % writer.encode(), b"w")
    assert api.read(b"home/%s" % writer.encode()) == b"w"
    items = [(b"home/%s/%d" % (writer.encode(), i), b"v%d" % i) for i in range(4)]
    assert api.write_many(items) == [None] * 4
    assert api.read_many([v for v, _ in items]) == [v for _, v in items]
