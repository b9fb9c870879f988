"""The port's GnuPG keyring importer (``bftkv_tpu_torch/cmd/import_gpg.py``)
against the reference's cases (``tests/test_import_gpg.py``): a miniature
reference universe made with the local ``gpg`` (skipped without it, as the
reference's cases are), imported with identities, secret keys and verified
trust edges; a tampered certification rejected; a protected secret key
skipped; per-home views with ``localtrust``.  Across the packages: equal
``parse_keyring`` records and ``ImportResult``s on the same rings, and
homes written by the port's ``write_native_homes`` loading in both
packages' ``load_home`` with equal reachable sets.  The committed universe
under ``tests/data/gpg_universe/`` (made by its ``make_universe.py``) needs
no ``gpg``: both packages import it to the same result."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest

from bftkv_tpu_torch.cmd import import_gpg

from test_torch_utils import DEVICE

GPG = shutil.which("gpg")
needs_gpg = pytest.mark.skipif(GPG is None, reason="gpg not installed")
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "gpg_universe")
FIXTURE_DIRS = [os.path.join(FIXTURE, n) for n in ("a01", "rw01", "u01")]


@pytest.fixture(scope="module")
def universe(tmp_path_factory):
    """The reference test's three-node universe, made anew by the
    committed generator (the same gpg calls)."""
    if GPG is None:
        pytest.skip("gpg not installed")
    sys.path.insert(0, FIXTURE)
    try:
        import make_universe
    finally:
        sys.path.remove(FIXTURE)
    root = tmp_path_factory.mktemp("gpgu")
    make_universe.make(str(root))
    return {name: str(root / name) for name in ("a01", "rw01", "u01")}


def _by_name(res):
    return {c.name: c for c in res.certs.values()}


@needs_gpg
def test_full_universe_import(universe, tmp_path):
    from bftkv_tpu_torch.topology import load_home

    res = import_gpg.import_homedirs(list(universe.values()))
    assert len(res.certs) == 3 and len(res.secrets) == 3
    by_name = _by_name(res)
    assert set(by_name) == {"a01", "rw01", "u01"}
    assert by_name["a01"].address == "localhost:5701"
    assert by_name["a01"].uid == "svc@example.com"
    assert by_name["u01"].address == ""
    want = {
        (by_name["a01"].id, by_name["rw01"].id),
        (by_name["rw01"].id, by_name["a01"].id),
        (by_name["rw01"].id, by_name["u01"].id),
    }
    assert set(res.edges) == want and res.unconverted == []
    for signer_id, signee_id in res.edges:
        assert res.certs[signee_id].verify_signature(res.certs[signer_id])
    out = tmp_path / "native"
    assert len(import_gpg.write_native_homes(res, str(out))) == 3
    graph, crypt, _qs = load_home(str(out / "rw01"), device=DEVICE)
    assert crypt.signer.cert.name == "rw01"
    reachable = {c.id for c in graph.get_reachable_nodes(by_name["rw01"].id, 1)}
    assert by_name["a01"].id in reachable


@needs_gpg
def test_single_homedir_unknown_issuer_dropped(universe):
    res = import_gpg.import_homedirs([universe["u01"]])
    assert "u01" in _by_name(res)
    assert len(res.secrets) == 1 and res.edges == [] and res.unconverted == []
    assert any("unverifiable" in n for n in res.notes)


@needs_gpg
def test_verified_edge_without_signer_secret_unconverted(universe, tmp_path):
    rw_pub = tmp_path / "rw01-pubonly"
    rw_pub.mkdir()
    with open(os.path.join(universe["rw01"], "pubring.gpg"), "rb") as f:
        (rw_pub / "pubring.gpg").write_bytes(f.read())
    res = import_gpg.import_homedirs([universe["u01"], str(rw_pub)])
    by_name = _by_name(res)
    assert len(res.secrets) == 1
    assert (by_name["rw01"].id, by_name["u01"].id) not in set(res.edges)
    assert any(t == by_name["u01"].id for _, t in res.unconverted)
    assert by_name["rw01"].id not in by_name["u01"].signatures


@needs_gpg
def test_tampered_certification_rejected(universe):
    with open(os.path.join(universe["rw01"], "pubring.gpg"), "rb") as f:
        intact_bytes = f.read()
    intact = import_gpg.parse_keyring(intact_bytes)
    intact_edges = sum(len(k.certified_by) for k in intact.keys.values())
    assert intact_edges >= 2
    data = bytearray(intact_bytes)
    data[-10] ^= 0x40
    ring = import_gpg.parse_keyring(bytes(data))
    tampered_edges = sum(len(k.certified_by) for k in ring.keys.values())
    assert tampered_edges < intact_edges or any(
        "BAD certification" in n or "parse error" in n for n in ring.notes
    )


@needs_gpg
def test_protected_secret_key_skipped(tmp_path):
    home = str(tmp_path / ".prot")
    os.makedirs(home, mode=0o700)
    base = [GPG, "--homedir", home, "--batch", "--no-tty", "--yes",
            "--pinentry-mode", "loopback", "--passphrase", "hunter2"]
    try:
        subprocess.run(base + ["--quick-gen-key", "prot <p@x>", "rsa2048", "sign", "never"],
                       capture_output=True, check=True)
        out = subprocess.run(base + ["--export-secret-key"], capture_output=True, check=True).stdout
    finally:
        if shutil.which("gpgconf"):
            subprocess.run(["gpgconf", "--homedir", home, "--kill", "gpg-agent"], capture_output=True)
    d = tmp_path / "prot"
    d.mkdir()
    (d / "secring.gpg").write_bytes(out)
    res = import_gpg.import_homedirs([str(d)])
    assert len(res.certs) == 1 and res.secrets == {}


@needs_gpg
def test_written_homes_keep_ring_locality(universe, tmp_path):
    from bftkv_tpu_torch.crypto.keyring import Keyring

    res = import_gpg.import_homedirs(list(universe.values()))
    out = tmp_path / "homes"
    import_gpg.write_native_homes(res, str(out))
    by_name = _by_name(res)
    certs = {c.name: c for c in Keyring().load_pubring(str(out / "rw01" / "pubring"))}
    assert by_name["rw01"].id not in certs["a01"].signatures
    assert by_name["rw01"].id not in certs["u01"].signatures
    with open(os.path.join(str(out / "rw01"), "localtrust")) as f:
        lt = {int(line, 16) for line in f if line.strip()}
    assert by_name["a01"].id in lt and by_name["u01"].id in lt
    assert by_name["a01"].id in certs["rw01"].signatures


# -- across the packages ----------------------------------------------------


def _secret(s):
    if s is None:
        return None
    if hasattr(s, "q"):
        return ("rsa", s.n, s.e, s.d, s.p, s.q)
    return ("ec", s.d, s.public.x, s.public.y)


def _record(k):
    return (k.keyid, k.fingerprint, k.algo, k.body, k.n, k.e, k.point, k.uid,
            sorted(k.certified_by), _secret(k.secret))


def _ring(parsed):
    return {kid: _record(k) for kid, k in parsed.keys.items()}, parsed.notes


def _cert(c):
    return (c.id, c.name, c.address, c.uid, c.alg, c.point, sorted(c.signatures.items()))


def _result(res):
    return ({i: _cert(c) for i, c in res.certs.items()}, sorted(res.secrets),
            res.edges, res.unconverted, res.notes,
            [(h.path, h.owner_kid, {kid: _record(k) for kid, k in h.keys.items()}) for h in res.homes])


def _assert_equal_imports(dirs, tamper: bool = True):
    from bftkv_tpu.cmd import import_gpg as ref

    for d in dirs:
        for fname in ("pubring.gpg", "secring.gpg"):
            path = os.path.join(d, fname)
            if not os.path.exists(path):
                continue
            data = open(path, "rb").read()
            variants = [data]
            if tamper:
                bad = bytearray(data)
                bad[-10] ^= 0x40
                variants += [bytes(bad), data[: len(data) // 2]]
            for blob in variants:
                assert _ring(import_gpg.parse_keyring(blob)) == _ring(ref.parse_keyring(blob))
    for subset in (dirs, dirs[-1:], dirs[:2]):
        got, want = import_gpg.import_homedirs(subset), ref.import_homedirs(subset)
        assert _result(got) == _result(want)


@needs_gpg
def test_parse_and_import_equal_the_references(universe):
    """Same rings (intact, tampered, cut short), same records; same
    homedir sets, same cert ids, signatures, edges, unconverted edges,
    notes and per-home views."""
    _assert_equal_imports(list(universe.values()))


def test_committed_fixture_imports_equal_in_both_packages():
    """The committed universe (no gpg needed): three identities, their
    secret keys and the three cross-signatures as native edges, equal to
    the reference's import of the same files."""
    res = import_gpg.import_homedirs(FIXTURE_DIRS)
    by_name = _by_name(res)
    assert set(by_name) == {"a01", "rw01", "u01"} and len(res.secrets) == 3
    assert set(res.edges) == {
        (by_name["a01"].id, by_name["rw01"].id),
        (by_name["rw01"].id, by_name["a01"].id),
        (by_name["rw01"].id, by_name["u01"].id),
    }
    assert res.unconverted == []
    _assert_equal_imports(FIXTURE_DIRS)


def test_written_homes_load_in_both_packages(tmp_path):
    """A home written by the port's ``write_native_homes`` loads in the
    port's and the reference's ``load_home`` with the same self, the same
    keyring ids and the same reachable sets from every identity."""
    from bftkv_tpu.topology import load_home as ref_load_home
    from bftkv_tpu_torch.topology import load_home

    res = import_gpg.import_homedirs(FIXTURE_DIRS)
    written = import_gpg.write_native_homes(res, str(tmp_path / "homes"))
    assert sorted(os.path.basename(p) for p in written) == ["a01", "rw01", "u01"]
    for path in written:
        pg, pcr, _pq = load_home(path, device=DEVICE)
        rg, rcr, _rq = ref_load_home(path)
        assert pcr.signer.cert.id == rcr.signer.cert.id
        for cid in res.certs:
            for depth in (1, 2):
                assert ({c.id for c in pg.get_reachable_nodes(cid, depth)}
                        == {c.id for c in rg.get_reachable_nodes(cid, depth)}), (path, cid, depth)
    # The port's home for rw01 reaches a01 through a01's signature.
    by_name = _by_name(res)
    pg, _c, _q = load_home(str(tmp_path / "homes" / "rw01"), device=DEVICE)
    assert by_name["a01"].id in {c.id for c in pg.get_reachable_nodes(by_name["rw01"].id, 1)}


def test_main_writes_the_homes(tmp_path, capsys):
    assert import_gpg.main(["--out", str(tmp_path / "o"), *FIXTURE_DIRS]) == 0
    out = capsys.readouterr().out
    assert "imported 3 identities (3 with secret keys), 3 trust edges re-signed natively" in out
    assert sorted(os.listdir(tmp_path / "o")) == ["a01", "rw01", "u01"]
