"""Compact certificate format — node identity and trust edges (counterpart
of ``bftkv_tpu/crypto/cert.py``, byte for byte the same format).

Capability parity with the reference's certificate interface
(reference: crypto/cert/cert.go:6-16 — id, name, address, uid, signers,
serialization, active flag) without PGP packet grammar: only the *fields*
are the capability (SURVEY.md §7 phase 3). A certificate doubles as the
``Node`` object (reference: node/node.go:12-27 — ``Node =
CertificateInstance``); trust edges are the embedded signatures
(signer → signee), which the graph layer consumes directly.

Wire layout (all chunks length-prefixed per ``bftkv_tpu.packet``):

    RSA:   magic "BCR1" | chunk(n big-endian) | u32 e | chunk(name) |
           chunk(address) | chunk(uid) | u16 nsigs | nsigs ×
           (u64 signer_id | chunk(sig))
    ECDSA: magic "BCR2" | chunk(alg, e.g. b"p256") | chunk(SEC1 point) |
           chunk(name) | chunk(address) | chunk(uid) | u16 nsigs | ...

The to-be-signed region is everything before ``nsigs``; a signature is
issued by the signer's key in the signer's own algorithm (PKCS#1
v1.5/SHA-256 for RSA, 64-byte r‖s ECDSA/SHA-256 for P-256 — matching
the reference's algorithm-agnostic verify, crypto_pgp.go:310-405). The
node id is the first 8 bytes (big-endian) of SHA-256 over the public
key — the analog of the PGP 64-bit key id.
"""

from __future__ import annotations

import hashlib
import io
import struct
from dataclasses import dataclass, field

from bftkv_tpu_torch.errors import ERR_INVALID_SIGNATURE, ERR_MALFORMED_REQUEST
from bftkv_tpu_torch.packet import read_chunk, write_chunk

# crypto/rsa.py imports this module (``is_ec``), so rsa and ecdsa are
# imported where they are used.

_MAGIC = b"BCR1"
_MAGIC_EC = b"BCR2"

ALG_RSA = "rsa"
ALG_P256 = "p256"

# u16 wire field bounds the signer set; merge()/add_signature enforce it.
MAX_SIGNATURES = 0xFFFF

F4 = 65537


def key_id(n: int, e: int) -> int:
    h = hashlib.sha256()
    h.update(n.to_bytes((n.bit_length() + 7) // 8, "big"))
    h.update(struct.pack(">I", e))
    return struct.unpack(">Q", h.digest()[:8])[0]


def key_id_ec(alg: str, point: bytes) -> int:
    h = hashlib.sha256()
    h.update(alg.encode())
    h.update(point)
    return struct.unpack(">Q", h.digest()[:8])[0]


def is_ec(key) -> bool:
    """True for EC key objects (public or private) — the one algorithm
    dispatch rule every layer shares."""
    return hasattr(key, "curve")


def private_key_id(key) -> int:
    """Node id for either private-key type (keyring registration)."""
    if is_ec(key):
        return key_id_ec(ALG_P256, key.public.marshal())
    return key_id(key.n, key.e)


@dataclass
class Certificate:
    """A parsed certificate; implements the Node capability set."""

    n: int
    e: int = F4
    name: str = ""
    address: str = ""
    uid: str = ""
    # signer_id -> signature bytes over tbs(); dict keeps one edge per signer
    signatures: dict[int, bytes] = field(default_factory=dict)
    active: bool = True
    alg: str = ALG_RSA
    point: bytes = b""  # SEC1 public point (EC certs; n/e are 0)

    # -- identity ---------------------------------------------------------
    @property
    def id(self) -> int:
        # Cached: id backs __hash__/__eq__ and the hot graph/quorum
        # loops; the key material never changes after construction.
        cached = self.__dict__.get("_id")
        if cached is None:
            if self.alg == ALG_RSA:
                cached = key_id(self.n, self.e)
            else:
                cached = key_id_ec(self.alg, self.point)
            self.__dict__["_id"] = cached
        return cached

    @property
    def public_key(self):
        if self.alg == ALG_RSA:
            from bftkv_tpu_torch.crypto import rsa

            return rsa.PublicKey(n=self.n, e=self.e)
        from bftkv_tpu_torch.crypto import ecdsa as _ecdsa

        return _ecdsa.public_from_bytes(self.point)

    def __hash__(self) -> int:
        return hash(self.id)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Certificate) and other.id == self.id

    # -- serialization ----------------------------------------------------
    def tbs(self) -> bytes:
        buf = io.BytesIO()
        if self.alg == ALG_RSA:
            buf.write(_MAGIC)
            nb = self.n.to_bytes((self.n.bit_length() + 7) // 8, "big")
            write_chunk(buf, nb)
            buf.write(struct.pack(">I", self.e))
        else:
            buf.write(_MAGIC_EC)
            write_chunk(buf, self.alg.encode())
            write_chunk(buf, self.point)
        write_chunk(buf, self.name.encode())
        write_chunk(buf, self.address.encode())
        write_chunk(buf, self.uid.encode())
        return buf.getvalue()

    def serialize(self) -> bytes:
        buf = io.BytesIO()
        buf.write(self.tbs())
        buf.write(struct.pack(">H", len(self.signatures)))
        for signer_id, sig in self.signatures.items():
            buf.write(struct.pack(">Q", signer_id))
            write_chunk(buf, sig)
        return buf.getvalue()

    # -- trust edges ------------------------------------------------------
    def signers(self) -> list[int]:
        """Ids of nodes that signed this certificate (trust edges in)."""
        return list(self.signatures.keys())

    def add_signature(self, signer_id: int, sig: bytes) -> None:
        # The wire count field is u16; refuse growth past it so
        # serialize() can never fail mid-protocol on a merged cert.
        if len(self.signatures) >= MAX_SIGNATURES and signer_id not in self.signatures:
            return
        self.signatures[signer_id] = sig

    def verify_signature(self, signer: "Certificate") -> bool:
        """Check ``signer``'s edge onto this cert (in the *signer*'s
        algorithm — reference: crypto_pgp.go:310-405)."""
        sig = self.signatures.get(signer.id)
        if sig is None:
            return False
        return verify_detached(self.tbs(), sig, signer)

    def merge(self, other: "Certificate") -> None:
        """Union the signature sets (reference: crypto_pgp.go:283-305)."""
        if other.id != self.id:
            raise ERR_INVALID_SIGNATURE
        for signer_id, sig in other.signatures.items():
            if signer_id in self.signatures:
                continue
            if len(self.signatures) >= MAX_SIGNATURES:
                break
            self.signatures[signer_id] = sig


def verify_detached(tbs: bytes, sig: bytes, signer: "Certificate") -> bool:
    """Verify ``sig`` over ``tbs`` in the signer's own algorithm."""
    try:
        if signer.alg == ALG_RSA:
            from bftkv_tpu_torch.crypto import rsa

            return rsa.verify_host(tbs, sig, signer.public_key)
        from bftkv_tpu_torch.crypto import ecdsa as _ecdsa

        return _ecdsa.verify_host(tbs, sig, signer.public_key)
    except Exception:
        return False


def sign_certificate(cert: Certificate, signer_key) -> None:
    """Add signer's trust edge onto ``cert``
    (reference: crypto_pgp.go:252-281).  ``signer_key`` is an RSA or an
    ECDSA private key; the edge is issued in its algorithm."""
    if is_ec(signer_key):
        from bftkv_tpu_torch.crypto import ecdsa as _ecdsa

        sig = _ecdsa.sign(cert.tbs(), signer_key)
    else:
        from bftkv_tpu_torch.crypto import rsa

        sig = rsa.sign(cert.tbs(), signer_key)
    cert.add_signature(private_key_id(signer_key), sig)


def make_ec_certificate(
    pub, *, name: str = "", address: str = "", uid: str = ""
) -> Certificate:
    """Certificate over an :class:`bftkv_tpu_torch.crypto.ecdsa.ECPublicKey`."""
    return Certificate(
        n=0, e=0, name=name, address=address, uid=uid,
        alg=ALG_P256, point=pub.marshal(),
    )


def _parse_one(r: io.BytesIO) -> Certificate | None:
    magic = r.read(4)
    if len(magic) == 0:
        return None
    if magic not in (_MAGIC, _MAGIC_EC):
        raise ERR_MALFORMED_REQUEST
    try:
        n = e = 0
        alg, point = ALG_RSA, b""
        if magic == _MAGIC:
            nb = read_chunk(r)
            if nb is None:
                raise ERR_MALFORMED_REQUEST
            n = int.from_bytes(nb, "big")
            eb = r.read(4)
            if len(eb) < 4:
                raise ERR_MALFORMED_REQUEST
            e = struct.unpack(">I", eb)[0]
        else:
            alg = (read_chunk(r) or b"").decode()
            point = read_chunk(r) or b""
            if alg != ALG_P256:
                raise ERR_MALFORMED_REQUEST
            # Validate the point once at the trust boundary so
            # ``public_key`` on a parsed cert cannot blow up later.
            from bftkv_tpu_torch.crypto import ecdsa as _ecdsa

            _ecdsa.public_from_bytes(point)
        name = (read_chunk(r) or b"").decode()
        address = (read_chunk(r) or b"").decode()
        uid = (read_chunk(r) or b"").decode()
        cb = r.read(2)
        if len(cb) < 2:
            raise ERR_MALFORMED_REQUEST
        nsigs = struct.unpack(">H", cb)[0]
        sigs: dict[int, bytes] = {}
        for _ in range(nsigs):
            ib = r.read(8)
            if len(ib) < 8:
                raise ERR_MALFORMED_REQUEST
            signer_id = struct.unpack(">Q", ib)[0]
            sigs[signer_id] = read_chunk(r) or b""
    except (EOFError, UnicodeDecodeError):
        # Truncated records and non-UTF-8 field bytes are malformed
        # certificates, never unhandled exceptions.
        raise ERR_MALFORMED_REQUEST from None
    return Certificate(
        n=n,
        e=e,
        name=name,
        address=address,
        uid=uid,
        signatures=sigs,
        alg=alg,
        point=point,
    )


def parse(data: bytes) -> list[Certificate]:
    """Parse a concatenation of certificates (a "ring" fragment,
    reference: crypto_pgp.go:228-250)."""
    r = io.BytesIO(data)
    out: list[Certificate] = []
    while True:
        c = _parse_one(r)
        if c is None:
            return out
        out.append(c)


def serialize_many(certs: list[Certificate]) -> bytes:
    return b"".join(c.serialize() for c in certs)
