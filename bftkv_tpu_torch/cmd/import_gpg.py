"""One-way GnuPG keyring importer — the reference operator's migration
path (counterpart of ``bftkv_tpu/cmd/import_gpg.py``).

The reference's entire identity universe is GnuPG homedirs generated
and cross-signed by ``scripts/setup.sh`` (reference:
scripts/setup.sh:17-48, scripts/gen.sh, scripts/trust.sh; keyring load
at crypto/pgp/crypto_pgp.go:115-223).  Each node directory holds

    <name>/pubring.gpg   — every key this node knows + the PGP
                           certifications (trust edges) it has imported
    <name>/secring.gpg   — this node's own secret key

This tool converts those into this framework's native home layout
(``bftkv_tpu_torch.topology.save_home``: compact-cert ``pubring``, ``BSK1``
``secring``), re-issuing trust edges as **native compact-cert
signatures**:

- every PGP certification is first **verified against the PGP v4
  signature hash** (RFC 4880 §5.2.4) — a tampered pubring cannot mint
  native trust;
- an edge is re-signed natively when the *signer's* secret key is
  among the imported homedirs.  Migrating a whole cluster
  (``import_gpg --out native run/keys/a01 run/keys/a02 ...``) therefore
  reconstructs the complete trust graph with real signatures;
- verified edges whose signer key is *not* available (single-homedir
  import of third-party certifications) cannot be forged — they are
  reported as ``unconverted`` so the operator can re-sign from the
  signer's node, and (when importing that one homedir's own view) the
  self node's outbound edges are still covered by its secring.

PGP packet grammar support is deliberately read-only and minimal: v4
RSA (algo 1/3) and ECDSA P-256 (algo 19) primary keys, UserID packets,
certification signatures 0x10-0x13, unprotected v4 secret keys (the
reference's keys are passphrase-less, scripts/gen.sh).  Everything else
(subkeys, v3/v5 packets, protected keys) is skipped with a note —
this is an importer, not a PGP implementation (SURVEY §7 scoped PGP
grammar out as a capability; see docs/DESIGN.md §1.1).

The importer is host code: the certification checks are host ``pow``
and the host P-256 curve (``crypto/ec.py``), and it takes no device.
The homes it writes load with ``topology.load_home(path, device=...)``.

    python -m bftkv_tpu_torch.cmd.import_gpg --out native run/keys/a01 ...
"""

from __future__ import annotations

import hashlib
import io
import os
import re
import sys
from dataclasses import dataclass, field

from bftkv_tpu_torch.crypto import cert as certmod
from bftkv_tpu_torch.crypto import ec, rsa
from bftkv_tpu_torch.crypto.ecdsa import ECPrivateKey, ECPublicKey

__all__ = ["parse_keyring", "import_homedirs", "main"]

# -- OpenPGP packet layer ---------------------------------------------------

TAG_SIGNATURE = 2
TAG_SECRET_KEY = 5
TAG_PUBLIC_KEY = 6
TAG_SECRET_SUBKEY = 7
TAG_USER_ID = 13
TAG_PUBLIC_SUBKEY = 14

ALGO_RSA = (1, 3)  # RSA encrypt-or-sign, RSA sign-only
ALGO_ECDSA = 19

_OID_P256 = bytes.fromhex("2a8648ce3d030107")

_HASHES = {
    1: "md5", 2: "sha1", 3: "ripemd160",
    8: "sha256", 9: "sha384", 10: "sha512", 11: "sha224",
}

# DigestInfo prefixes for EMSA-PKCS1-v1_5 (RFC 8017 §9.2 notes).
_DIGESTINFO = {
    "sha1": bytes.fromhex("3021300906052b0e03021a05000414"),
    "sha224": bytes.fromhex("302d300d06096086480165030402040500041c"),
    "sha256": bytes.fromhex("3031300d060960864801650304020105000420"),
    "sha384": bytes.fromhex("3041300d060960864801650304020205000430"),
    "sha512": bytes.fromhex("3051300d060960864801650304020305000440"),
}


class ImportError_(Exception):
    pass


def _iter_packets(data: bytes):
    """Yield ``(tag, body)`` for each OpenPGP packet (RFC 4880 §4)."""
    i, n = 0, len(data)
    while i < n:
        hdr = data[i]
        if not hdr & 0x80:
            raise ImportError_(f"bad packet header byte {hdr:#x} at {i}")
        if hdr & 0x40:  # new format
            tag = hdr & 0x3F
            i += 1
            body = bytearray()
            while True:
                if i >= n:
                    raise ImportError_("truncated packet length")
                o1 = data[i]
                if o1 < 192:
                    ln, i = o1, i + 1
                    partial = False
                elif o1 < 224:
                    ln = ((o1 - 192) << 8) + data[i + 1] + 192
                    i += 2
                    partial = False
                elif o1 == 255:
                    ln = int.from_bytes(data[i + 1 : i + 5], "big")
                    i += 5
                    partial = False
                else:  # 224..254: partial body length
                    ln = 1 << (o1 & 0x1F)
                    i += 1
                    partial = True
                body += data[i : i + ln]
                i += ln
                if not partial:
                    break
            yield tag, bytes(body)
        else:  # old format
            tag = (hdr >> 2) & 0x0F
            lentype = hdr & 0x03
            i += 1
            if lentype == 0:
                ln, i = data[i], i + 1
            elif lentype == 1:
                ln = int.from_bytes(data[i : i + 2], "big")
                i += 2
            elif lentype == 2:
                ln = int.from_bytes(data[i : i + 4], "big")
                i += 4
            else:  # indeterminate: rest of input
                ln = n - i
            yield tag, data[i : i + ln]
            i += ln


def _read_mpi(r: io.BytesIO) -> int:
    hdr = r.read(2)
    if len(hdr) < 2:
        raise ImportError_("truncated MPI")
    bits = int.from_bytes(hdr, "big")
    nbytes = (bits + 7) // 8
    raw = r.read(nbytes)
    if len(raw) < nbytes:
        raise ImportError_("truncated MPI body")
    return int.from_bytes(raw, "big")


# -- parsed structures ------------------------------------------------------


@dataclass
class PGPKey:
    keyid: bytes  # 8-byte PGP v4 key id
    fingerprint: bytes
    algo: int
    body: bytes  # raw public-key packet body (for sig hashing)
    n: int = 0
    e: int = 0
    point: bytes = b""  # SEC1 point for ECDSA
    uid: str = ""  # first user id string
    # verified certifications: set of issuer 8-byte keyids (self excluded)
    certified_by: set = field(default_factory=set)
    secret: object = None  # rsa.PrivateKey | ECPrivateKey when available


@dataclass
class Sig:
    sigtype: int
    pkalgo: int
    hashalgo: int
    hashed_raw: bytes  # version..hashed subpackets, for the v4 trailer
    issuer: bytes | None
    left16: bytes
    mpis: list


def _parse_pubkey_body(body: bytes) -> PGPKey | None:
    r = io.BytesIO(body)
    ver = r.read(1)[0]
    if ver != 4:
        return None
    r.read(4)  # creation time
    algo = r.read(1)[0]
    fpr = hashlib.sha1(
        b"\x99" + len(body).to_bytes(2, "big") + body
    ).digest()
    key = PGPKey(keyid=fpr[-8:], fingerprint=fpr, algo=algo, body=body)
    if algo in ALGO_RSA:
        key.n = _read_mpi(r)
        key.e = _read_mpi(r)
    elif algo == ALGO_ECDSA:
        oid_len = r.read(1)[0]
        oid = r.read(oid_len)
        if oid != _OID_P256:
            return None
        bits = int.from_bytes(r.read(2), "big")
        key.point = r.read((bits + 7) // 8)
    else:
        return None
    return key


def _parse_secret_body(body: bytes):
    """(pubkey, private) for an unprotected v4 secret key, else None."""
    pub = _parse_pubkey_body(body)
    if pub is None:
        return None
    # Re-walk to find where the public material ends; the packet body
    # for sig hashing (and the fingerprint/keyid) must be the *public*
    # form, not the secret packet body.
    r = io.BytesIO(body)
    r.read(6)
    if pub.algo in ALGO_RSA:
        _read_mpi(r), _read_mpi(r)
    else:
        oid_len = r.read(1)[0]
        r.read(oid_len)
        bits = int.from_bytes(r.read(2), "big")
        r.read((bits + 7) // 8)
    pub.body = body[: r.tell()]
    fpr = hashlib.sha1(
        b"\x99" + len(pub.body).to_bytes(2, "big") + pub.body
    ).digest()
    pub.fingerprint, pub.keyid = fpr, fpr[-8:]
    s2k_usage = r.read(1)
    if not s2k_usage or s2k_usage[0] != 0:
        return pub, None  # passphrase-protected: not supported
    try:
        if pub.algo in ALGO_RSA:
            d, p, q, _u = (_read_mpi(r) for _ in range(4))
            priv = rsa.PrivateKey(n=pub.n, e=pub.e, d=d, p=p, q=q)
        else:
            d = _read_mpi(r)
            pt = ec.P256.scalar_base_mult(d)
            priv = ECPrivateKey(
                d=d, public=ECPublicKey(x=pt[0], y=pt[1])
            )
    except ImportError_:
        return pub, None
    return pub, priv


def _parse_sig_body(body: bytes) -> Sig | None:
    r = io.BytesIO(body)
    ver = r.read(1)[0]
    if ver != 4:
        return None
    sigtype = r.read(1)[0]
    pkalgo = r.read(1)[0]
    hashalgo = r.read(1)[0]
    hashed_len = int.from_bytes(r.read(2), "big")
    hashed = r.read(hashed_len)
    unhashed_len = int.from_bytes(r.read(2), "big")
    unhashed = r.read(unhashed_len)
    left16 = r.read(2)
    mpis = []
    try:
        while True:
            mpis.append(_read_mpi(r))
    except ImportError_:
        pass
    issuer = None
    for area in (hashed, unhashed):
        for sp_type, sp_data in _iter_subpackets(area):
            if sp_type == 16 and len(sp_data) == 8:
                issuer = sp_data
            elif sp_type == 33 and len(sp_data) >= 21:
                issuer = sp_data[-8:]  # issuer fingerprint → key id
    return Sig(
        sigtype=sigtype,
        pkalgo=pkalgo,
        hashalgo=hashalgo,
        hashed_raw=body[: 6 + hashed_len],
        issuer=issuer,
        left16=left16,
        mpis=mpis,
    )


def _iter_subpackets(area: bytes):
    i, n = 0, len(area)
    while i < n:
        o1 = area[i]
        if o1 < 192:
            ln, i = o1, i + 1
        elif o1 < 255:
            ln = ((o1 - 192) << 8) + area[i + 1] + 192
            i += 2
        else:
            ln = int.from_bytes(area[i + 1 : i + 5], "big")
            i += 5
        if ln == 0 or i + ln > n:
            return
        yield area[i] & 0x7F, area[i + 1 : i + ln]
        i += ln


# -- certification verification (RFC 4880 §5.2.4) ---------------------------


def _cert_digest(key_body: bytes, uid: bytes, sig: Sig):
    name = _HASHES.get(sig.hashalgo)
    if name is None:
        return None
    h = hashlib.new(name)
    h.update(b"\x99" + len(key_body).to_bytes(2, "big") + key_body)
    h.update(b"\xb4" + len(uid).to_bytes(4, "big") + uid)
    h.update(sig.hashed_raw)
    h.update(b"\x04\xff" + len(sig.hashed_raw).to_bytes(4, "big"))
    return h.digest(), name


def _verify_certification(
    signee: PGPKey, uid: bytes, sig: Sig, signer: PGPKey
) -> bool:
    out = _cert_digest(signee.body, uid, sig)
    if out is None:
        return False
    digest, name = out
    if sig.left16 != digest[:2]:
        return False
    if signer.algo in ALGO_RSA and sig.pkalgo in ALGO_RSA:
        if len(sig.mpis) != 1:
            return False
        prefix = _DIGESTINFO.get(name)
        if prefix is None:
            return False
        k = (signer.n.bit_length() + 7) // 8
        em = b"\x00\x01" + b"\xff" * (k - len(prefix) - len(digest) - 3)
        em += b"\x00" + prefix + digest
        return pow(sig.mpis[0], signer.e, signer.n) == int.from_bytes(
            em, "big"
        )
    if signer.algo == ALGO_ECDSA and sig.pkalgo == ALGO_ECDSA:
        if len(sig.mpis) != 2:
            return False
        return _ecdsa_raw_verify(digest, sig.mpis[0], sig.mpis[1], signer)
    return False


def _ecdsa_raw_verify(digest: bytes, r_: int, s: int, signer: PGPKey) -> bool:
    cv = ec.P256
    n = cv.n
    if not (0 < r_ < n and 0 < s < n):
        return False
    pt = ec.unmarshal(cv, signer.point)
    if pt is None:
        return False
    z = int.from_bytes(digest, "big")
    shift = max(0, 8 * len(digest) - n.bit_length())
    z >>= shift
    w = pow(s, -1, n)
    u1, u2 = (z * w) % n, (r_ * w) % n
    R = cv.add(cv.scalar_base_mult(u1), cv.scalar_mult(pt, u2))
    if R is None:
        return False
    return R[0] % n == r_ % n


# -- keyring walk -----------------------------------------------------------


@dataclass
class Keyring:
    keys: dict  # 8-byte keyid -> PGPKey (primary keys only)
    notes: list  # skipped/unsupported items, human-readable


def parse_keyring(data: bytes) -> Keyring:
    """Parse an exported public (or secret) keyring into primary keys,
    their first user id, and the set of **cryptographically verified**
    certifications on them."""
    keys: dict[bytes, PGPKey] = {}
    notes: list[str] = []
    pending: list[tuple[PGPKey, bytes, Sig]] = []  # unresolved issuers
    cur: PGPKey | None = None
    cur_uid: bytes | None = None
    in_subkey = False
    for tag, body in _iter_packets(data):
        try:
            if tag in (TAG_PUBLIC_KEY, TAG_SECRET_KEY):
                in_subkey = False
                cur_uid = None
                if tag == TAG_PUBLIC_KEY:
                    parsed = _parse_pubkey_body(body)
                    priv = None
                else:
                    out = _parse_secret_body(body)
                    parsed, priv = out if out else (None, None)
                if parsed is None:
                    cur = None
                    notes.append(f"skipped unsupported primary key (tag {tag})")
                    continue
                cur = keys.setdefault(parsed.keyid, parsed)
                if priv is not None:
                    cur.secret = priv
            elif tag in (TAG_PUBLIC_SUBKEY, TAG_SECRET_SUBKEY):
                in_subkey = True  # subkeys carry no trust edges
            elif tag == TAG_USER_ID and cur is not None and not in_subkey:
                uid = body.decode("utf-8", "replace")
                cur_uid = body
                if not cur.uid:
                    cur.uid = uid
            elif tag == TAG_SIGNATURE and cur is not None and not in_subkey:
                sig = _parse_sig_body(body)
                if sig is None or cur_uid is None:
                    continue
                if not 0x10 <= sig.sigtype <= 0x13:
                    continue  # not a certification
                if sig.issuer is None or sig.issuer == cur.keyid:
                    continue  # self-sig binds the uid; not a trust edge
                signer = keys.get(sig.issuer)
                if signer is None:
                    pending.append((cur, cur_uid, sig))
                elif _verify_certification(cur, cur_uid, sig, signer):
                    cur.certified_by.add(sig.issuer)
                else:
                    notes.append(
                        f"BAD certification on {cur.uid!r} by issuer "
                        f"{sig.issuer.hex()} — rejected"
                    )
        except ImportError_ as e:
            notes.append(f"packet parse error (tag {tag}): {e}")
    # Issuers that appeared later in the ring.
    for signee, uid, sig in pending:
        signer = keys.get(sig.issuer)
        if signer is None:
            notes.append(
                f"certification on {signee.uid!r} by unknown issuer "
                f"{sig.issuer.hex()} — unverifiable, dropped"
            )
        elif _verify_certification(signee, uid, sig, signer):
            signee.certified_by.add(sig.issuer)
        else:
            notes.append(
                f"BAD certification on {signee.uid!r} by issuer "
                f"{sig.issuer.hex()} — rejected"
            )
    return Keyring(keys=keys, notes=notes)


# -- native conversion ------------------------------------------------------

_UID_RE = re.compile(
    r"^\s*(?P<name>[^(<]*?)\s*(?:\((?P<addr>[^)]*)\))?\s*"
    r"(?:<(?P<mail>[^>]*)>)?\s*$"
)


def _to_cert(key: PGPKey) -> certmod.Certificate:
    m = _UID_RE.match(key.uid or "")
    name = (m.group("name") if m else "") or key.keyid.hex()
    addr = (m.group("addr") if m else "") or ""
    mail = (m.group("mail") if m else "") or ""
    if key.algo in ALGO_RSA:
        return certmod.Certificate(
            n=key.n, e=key.e, name=name, address=addr, uid=mail
        )
    return certmod.Certificate(
        n=0, e=0, name=name, address=addr, uid=mail,
        alg=certmod.ALG_P256, point=key.point,
    )


@dataclass
class HomeRing:
    """One homedir's parsed view: its keys and its own verified edges."""

    path: str
    keys: dict  # 8-byte keyid -> PGPKey, THIS ring's view only
    owner_kid: bytes | None  # key whose secret rides this homedir


@dataclass
class ImportResult:
    certs: dict  # our 64-bit id -> Certificate (union view, all edges)
    secrets: dict  # our 64-bit id -> private key
    edges: list  # (signer our-id, signee our-id) natively re-signed
    unconverted: list  # (signer keyid hex, signee our-id): no signer key
    notes: list
    homes: list = field(default_factory=list)  # HomeRing per input dir


def import_homedirs(homedirs: list[str]) -> ImportResult:
    """Parse every homedir's pubring.gpg/secring.gpg and rebuild the
    universe natively.  Edge policy per module docstring: verified-PGP
    certification + available signer secret → native signature."""
    keys: dict[bytes, PGPKey] = {}
    notes: list[str] = []
    homes: list[HomeRing] = []
    for hd in homedirs:
        home_keys: dict[bytes, PGPKey] = {}
        owner_kid: bytes | None = None
        for fname in ("pubring.gpg", "secring.gpg"):
            path = os.path.join(hd, fname)
            if not os.path.exists(path):
                continue
            with open(path, "rb") as f:
                ring = parse_keyring(f.read())
            notes += [f"{path}: {n}" for n in ring.notes]
            for kid, key in ring.keys.items():
                have = keys.setdefault(kid, key)
                if have is not key:
                    have.certified_by |= key.certified_by
                    if have.secret is None and key.secret is not None:
                        have.secret = key.secret
                    if not have.uid:
                        have.uid = key.uid
                # Per-home COPY (own certified_by set): the home view
                # must stay this ring's view, not the growing union.
                hk = home_keys.get(kid)
                if hk is None:
                    home_keys[kid] = PGPKey(
                        keyid=key.keyid, fingerprint=key.fingerprint,
                        algo=key.algo, body=key.body, n=key.n, e=key.e,
                        point=key.point, uid=key.uid,
                        certified_by=set(key.certified_by),
                        secret=key.secret,
                    )
                else:
                    hk.certified_by |= key.certified_by
                    if hk.secret is None and key.secret is not None:
                        hk.secret = key.secret
                    if not hk.uid:
                        hk.uid = key.uid
        for kid, key in home_keys.items():
            if key.secret is not None and owner_kid is None:
                owner_kid = kid
        homes.append(HomeRing(path=hd, keys=home_keys, owner_kid=owner_kid))
    certs: dict[int, certmod.Certificate] = {}
    secrets: dict[int, object] = {}
    by_kid: dict[bytes, certmod.Certificate] = {}
    for kid, key in keys.items():
        c = _to_cert(key)
        certs[c.id] = c
        by_kid[kid] = c
        if key.secret is not None:
            secrets[c.id] = key.secret
    edges: list[tuple[int, int]] = []
    unconverted: list[tuple[str, int]] = []
    for kid, key in keys.items():
        signee = by_kid[kid]
        for issuer_kid in sorted(key.certified_by):
            issuer = keys.get(issuer_kid)
            if issuer is not None and issuer.secret is not None:
                certmod.sign_certificate(signee, issuer.secret)
                edges.append((by_kid[issuer_kid].id, signee.id))
            else:
                unconverted.append((issuer_kid.hex(), signee.id))
    return ImportResult(
        certs=certs, secrets=secrets, edges=edges,
        unconverted=unconverted, notes=notes, homes=homes,
    )


def write_native_homes(res: ImportResult, out: str) -> list[str]:
    """One ``save_home`` directory per homedir that contributed a
    secret key.

    Views are PER-HOME, mirroring the reference's keyring locality
    (each node's trust graph comes from its own GnuPG ring): a home's
    pubring holds only the keys its ring held, carrying only the edges
    its ring verified.  A global union view would be unsound — e.g. a
    user's outbound certifications written into *server* homes combine
    with the servers' quorum-certificate signatures on the user into
    bidirectional user↔server edges in every graph, pulling the user
    into the servers' maximal clique and silently reshaping quorums
    (the round-4 ``server_trust_rw`` incident, docs/DESIGN.md §1.2).

    For the same reason the OWNER's own outbound certifications become
    ``localtrust`` entries (local-only graph edges, never serialized
    into certificates) — this framework's canonical form for a node's
    own trust decisions."""
    from bftkv_tpu_torch.topology import Identity, save_home

    # Secret pool spans every imported homedir (an edge in home A may
    # be signed by B's key when B's secring was also imported).
    union_secrets: dict[bytes, object] = {}
    for h in res.homes:
        for kid, key in h.keys.items():
            if key.secret is not None and kid not in union_secrets:
                union_secrets[kid] = key.secret

    written = []
    for home in res.homes:
        if home.owner_kid is None:
            continue
        owner_key = home.keys[home.owner_kid]
        view: list[certmod.Certificate] = []
        local_trust: list[int] = []
        owner_cert = None
        for kid, key in home.keys.items():
            c = _to_cert(key)
            for issuer_kid in sorted(key.certified_by):
                if issuer_kid == home.owner_kid:
                    local_trust.append(c.id)
                    continue
                secret = union_secrets.get(issuer_kid)
                if secret is not None:
                    certmod.sign_certificate(c, secret)
            view.append(c)
            if kid == home.owner_kid:
                owner_cert = c
        name = (owner_cert.name if owner_cert else "") or home.owner_kid.hex()
        path = os.path.join(out, name)
        save_home(
            path,
            Identity(name=name, key=owner_key.secret, cert=owner_cert),
            view,
            local_trust=sorted(set(local_trust) - {owner_cert.id}),
        )
        written.append(path)
    return written


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="import_gpg",
        description="Convert reference GnuPG homedirs (pubring.gpg + "
        "secring.gpg per node) into native bftkv_tpu_torch home directories.",
    )
    ap.add_argument("homedirs", nargs="+", help="reference key dirs "
                    "(e.g. run/keys/a01 run/keys/a02 ...)")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)
    res = import_homedirs(args.homedirs)
    written = write_native_homes(res, args.out)
    if not args.quiet:
        for n in res.notes:
            print(f"note: {n}", file=sys.stderr)
        print(
            f"imported {len(res.certs)} identities "
            f"({len(res.secrets)} with secret keys), "
            f"{len(res.edges)} trust edges re-signed natively, "
            f"{len(res.unconverted)} edges unconverted "
            "(signer secret key not among the imported homedirs)"
        )
        for path in written:
            print(f"  wrote {path}")
        if res.unconverted and not written:
            print(
                "hint: pass every node's homedir in one run so each "
                "edge's signer key is available",
                file=sys.stderr,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
