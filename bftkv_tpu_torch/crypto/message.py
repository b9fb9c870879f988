"""Message security: sign-then-encrypt with nonce echo + session keys
(counterpart of ``bftkv_tpu/crypto/message.py``).

Capability parity with the reference's transport session layer
(reference: crypto_pgp.go:418-471): every peer-to-peer payload is
confidential, authenticated to the sending identity, and carries a nonce
the responder must echo (replay protection — the reference smuggles the
nonce through the PGP literal-data filename; here it is a first-class
field).

Redesign (not in the Go reference): the reference pays a PGP
public-key sign + per-recipient encrypt on *every* message, which
profiling shows dominates the write path (~4 RSA-2048 private ops per
request/response pair). Here the asymmetric work happens once per peer
pair:

- **Bootstrap envelope (tag 0x01)** — the first message to a peer uses
  the full hybrid scheme: fresh AES-256-GCM content key wrapped
  per-recipient with RSA-OAEP(SHA-256), inner envelope signed by the
  sender, sender certificate included so a stranger (the Join flow,
  reference: server.go:64-120) can authenticate it. The signed inner
  additionally *grants* each recipient a pairwise session key
  (OAEP-wrapped to that recipient alone, so co-recipients cannot read
  each other's grants).
- **Session envelope (tag 0x02)** — subsequent messages wrap a fresh
  content key per-recipient under the pairwise session key with
  AES-GCM; no RSA anywhere. Authenticity follows from the session key
  being known only to the two peers of the RSA-authenticated bootstrap;
  a role byte in the key-wrap AAD kills reflection. Byzantine
  *accountability* never rested on this layer — protocol content is
  signed by certificates (collective signatures) regardless of how the
  transport session is keyed.
- A receiver that lost the session (restart, cache eviction) fails with
  the interned ``ERR_UNKNOWN_SESSION``; the transport fan-out catches it
  and retries that peer once with a fresh bootstrap (self-healing).

Wire formats:
    bootstrap: 0x01 | u16 n | n×(u64 rid | chunk(oaep(content_key))) |
               chunk(gcm_nonce | GCM(content_key, inner | chunk(sig)))
      inner  = chunk(plaintext) | chunk(nonce) | chunk(sender_cert) |
               chunk(grants);  grants = n×(u64 rid | chunk(session_id) |
               chunk(oaep(session_key)))
    session:   0x02 | u16 n | n×(u64 rid | chunk(session_id) |
               chunk(kw_nonce | GCM(session_key, content_key,
               aad=b"kw"+role))) |
               chunk(gcm_nonce | GCM(content_key, chunk(plaintext) |
               chunk(nonce)))
"""

from __future__ import annotations

import hashlib
import io
import struct
from collections import OrderedDict

from bftkv_tpu_torch.crypto import cert as certmod
from bftkv_tpu_torch.crypto import rng
from bftkv_tpu_torch.crypto import rsa
from bftkv_tpu_torch.crypto.aead import AESGCM
from bftkv_tpu_torch.crypto.aead import _xor as _bxor
from bftkv_tpu_torch.errors import (
    ERR_DECRYPTION_FAILURE,
    ERR_INVALID_SIGNATURE,
    ERR_INVALID_TRANSPORT_SECURITY_DATA,
    ERR_UNKNOWN_SESSION,
)
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.packet import read_chunk, write_chunk
from bftkv_tpu_torch.devtools.lockwatch import named_lock

# The host ``cryptography`` library accelerates the RSA-OAEP key wrap
# when present; without it (a host may lack the package)
# the pure-Python RFC 8017 OAEP below carries the bootstrap path —
# byte-compatible on the wire, it is the same OAEP(SHA-256).
try:  # pragma: no cover - branch depends on the host image
    from cryptography.hazmat.primitives import hashes as _hashes
    from cryptography.hazmat.primitives.asymmetric import padding as _padding
    from cryptography.hazmat.primitives.asymmetric import rsa as _crsa

    _OAEP = _padding.OAEP(
        mgf=_padding.MGF1(algorithm=_hashes.SHA256()),
        algorithm=_hashes.SHA256(),
        label=None,
    )
except Exception:
    # Same-stack requirement as the AEAD seam (crypto/aead.py logs the
    # downgrade once); the pure path IS byte-compatible OAEP, so this
    # one only changes speed, not the wire.
    _crsa = None
    _OAEP = None

_TAG_BOOTSTRAP = 0x01
_TAG_SESSION = 0x02

_ROLE_INITIATOR = 0
_ROLE_RESPONDER = 1


def _public(c: certmod.Certificate):
    return _crsa.RSAPublicNumbers(c.e, c.n).public_key()


def _private(key: rsa.PrivateKey):
    dmp1 = key.d % (key.p - 1)
    dmq1 = key.d % (key.q - 1)
    iqmp = pow(key.q, -1, key.p)
    pub = _crsa.RSAPublicNumbers(key.e, key.n)
    return _crsa.RSAPrivateNumbers(
        p=key.p, q=key.q, d=key.d, dmp1=dmp1, dmq1=dmq1, iqmp=iqmp,
        public_numbers=pub,
    ).private_key()


# -- pure-Python RSA-OAEP(SHA-256) fallback (RFC 8017 §7.1) ----------------

_HLEN = 32
_LHASH = hashlib.sha256(b"").digest()


def _mgf1(seed: bytes, n: int) -> bytes:
    out = b""
    for i in range((n + _HLEN - 1) // _HLEN):
        out += hashlib.sha256(seed + struct.pack(">I", i)).digest()
    return out[:n]


def _oaep_wrap_py(n: int, e: int, secret: bytes) -> bytes:
    k = (n.bit_length() + 7) // 8
    if len(secret) > k - 2 * _HLEN - 2:
        raise ValueError("oaep: message too long")
    ps = b"\x00" * (k - len(secret) - 2 * _HLEN - 2)
    db = _LHASH + ps + b"\x01" + secret
    seed = rng.generate_random(_HLEN)
    masked_db = _bxor(db, _mgf1(seed, k - _HLEN - 1))
    masked_seed = _bxor(seed, _mgf1(masked_db, _HLEN))
    em = int.from_bytes(b"\x00" + masked_seed + masked_db, "big")
    return pow(em, e, n).to_bytes(k, "big")


def _oaep_unwrap_py(key: rsa.PrivateKey, blob: bytes) -> bytes:
    k = (key.n.bit_length() + 7) // 8
    c = int.from_bytes(blob, "big")
    if len(blob) != k or c >= key.n:
        raise ValueError("oaep: malformed ciphertext")
    # CRT decrypt (native Montgomery modexp when built — the bootstrap
    # envelope's private op rides the same primitive as signing).
    em = rsa.crt_pow_d(c, key).to_bytes(k, "big")
    masked_seed, masked_db = em[1 : 1 + _HLEN], em[1 + _HLEN :]
    seed = _bxor(masked_seed, _mgf1(masked_db, _HLEN))
    db = _bxor(masked_db, _mgf1(seed, k - _HLEN - 1))
    sep = db.find(b"\x01", _HLEN)
    if (
        em[0] != 0
        or db[:_HLEN] != _LHASH
        or sep < 0
        or any(db[_HLEN:sep])
    ):
        raise ValueError("oaep: decoding error")
    return db[sep + 1 :]


def _wrap_to(c: certmod.Certificate, secret: bytes) -> bytes:
    """Key-wrap ``secret`` to a peer in the peer's own algorithm:
    RSA-OAEP(SHA-256) for RSA certs, ECIES (ephemeral ECDH + HKDF +
    AES-GCM) for P-256 certs.  The recipient knows its own key type, so
    no wire tag is needed."""
    if c.alg == certmod.ALG_RSA:
        if _crsa is not None:
            return _public(c).encrypt(secret, _OAEP)
        return _oaep_wrap_py(c.n, c.e, secret)
    from bftkv_tpu_torch.crypto import ecdsa as _ecdsa

    return _ecdsa.ecies_wrap(secret, c.public_key)


class _SessionOut:
    __slots__ = ("sid", "key", "role")

    def __init__(self, sid: bytes, key: bytes, role: int):
        self.sid = sid
        self.key = key
        self.role = role


class _SessionIn:
    __slots__ = ("key", "peer", "peer_role")

    def __init__(self, key: bytes, peer: certmod.Certificate, peer_role: int):
        self.key = key
        self.peer = peer
        self.peer_role = peer_role


class MessageSecurity:
    """Bound to one identity (signing key + cert)."""

    #: Hostile peers can spam bootstraps; both caches are LRU-bounded.
    _CACHE_MAX = 8192

    def __init__(self, key, certificate: certmod.Certificate):
        """``key`` is an RSA or an ECDSA P-256 private key (matching
        ``certificate``); envelopes to/from this identity use its
        algorithm for both key unwrap and the bootstrap signature."""
        self.key = key
        self.cert = certificate
        self._is_ec = certmod.is_ec(key)
        self._priv = (
            None if self._is_ec or _crsa is None else _private(key)
        )
        self._lock = named_lock("crypto.sessions")
        # peer id -> _SessionOut (how I encrypt *to* that peer)
        self._by_peer: "OrderedDict[int, _SessionOut]" = OrderedDict()
        # session id -> _SessionIn (how I decrypt *from* its peer)
        self._by_id: "OrderedDict[bytes, _SessionIn]" = OrderedDict()

    # -- session cache ----------------------------------------------------

    def _lru_put(self, od: OrderedDict, k, v) -> None:
        od[k] = v
        od.move_to_end(k)
        if len(od) > self._CACHE_MAX:
            od.popitem(last=False)

    def invalidate(self, peer_id: int) -> None:
        """Drop the outbound session to ``peer_id`` (the transport calls
        this when the peer reports ERR_UNKNOWN_SESSION)."""
        with self._lock:
            self._by_peer.pop(peer_id, None)

    def has_session(self, peer_id: int) -> bool:
        """Whether a message to ``peer_id`` would take the session fast
        path — the presession pump's cold-peer probe (a stale-but-
        present session still answers True; staleness is only learnable
        from the peer's ERR_UNKNOWN_SESSION, which the transport heals
        with a single-peer reseal)."""
        with self._lock:
            return peer_id in self._by_peer

    def _sessions_for(self, recipients) -> list[_SessionOut] | None:
        with self._lock:
            out = []
            for r in recipients:
                s = self._by_peer.get(r.id)
                if s is None:
                    return None
                out.append(s)
            return out

    # -- encrypt ----------------------------------------------------------

    def encrypt(
        self,
        recipients: list[certmod.Certificate],
        plaintext: bytes,
        nonce: bytes,
        *,
        force_bootstrap: bool = False,
    ) -> bytes:
        """``force_bootstrap`` always emits the self-contained RSA
        envelope. The transport's unknown-session retry needs it: a
        fast-path envelope can overtake its establishing bootstrap (the
        sender commits a session at *encrypt* time, the receiver learns
        it at *delivery* time), and a retry that merely invalidates can
        race with another thread re-installing a not-yet-delivered
        session — a bootstrap is decryptable unconditionally."""
        if not force_bootstrap:
            sessions = self._sessions_for(recipients)
            if sessions is not None:
                return self._encrypt_session(
                    recipients, sessions, plaintext, nonce
                )
        return self._encrypt_bootstrap(recipients, plaintext, nonce)

    def encrypt_grouped(
        self,
        recipients: list[certmod.Certificate],
        plaintext: bytes,
        nonce: bytes,
    ) -> list[bytes]:
        """Per-recipient envelopes for ONE shared plaintext, sealed at
        most twice: one session envelope covering every recipient that
        holds a pairwise session, one bootstrap envelope covering the
        rest.  ``encrypt`` degrades the whole set to the bootstrap path
        (RSA sign + per-recipient OAEP) whenever ANY recipient lacks a
        session — so a single cold or restarted peer in a quorum made
        every round re-encrypt for everyone.  The multicast fan-out
        uses this instead (transport.multicast, single-payload mode).

        Returns one cipher blob per recipient, aligned with
        ``recipients``; group members share the identical object."""
        with self._lock:
            sessions = [self._by_peer.get(r.id) for r in recipients]
        warm = [
            (i, s) for i, s in enumerate(sessions) if s is not None
        ]
        cold = [i for i, s in enumerate(sessions) if s is None]
        if not cold:
            cipher = self._encrypt_session(
                recipients, [s for _, s in warm], plaintext, nonce
            )
            return [cipher] * len(recipients)
        if not warm:
            cipher = self._encrypt_bootstrap(recipients, plaintext, nonce)
            return [cipher] * len(recipients)
        out: list[bytes | None] = [None] * len(recipients)
        warm_cipher = self._encrypt_session(
            [recipients[i] for i, _ in warm],
            [s for _, s in warm],
            plaintext,
            nonce,
        )
        cold_cipher = self._encrypt_bootstrap(
            [recipients[i] for i in cold], plaintext, nonce
        )
        for i, _ in warm:
            out[i] = warm_cipher
        for i in cold:
            out[i] = cold_cipher
        return out

    def _encrypt_session(
        self, recipients, sessions: list[_SessionOut], plaintext, nonce
    ) -> bytes:
        inner = io.BytesIO()
        write_chunk(inner, plaintext)
        write_chunk(inner, nonce)
        content_key = rng.generate_random(32)
        gcm_nonce = rng.generate_random(12)
        ct = AESGCM(content_key).encrypt(gcm_nonce, inner.getvalue(), b"data")

        out = io.BytesIO()
        out.write(bytes([_TAG_SESSION]))
        out.write(struct.pack(">H", len(recipients)))
        for r, s in zip(recipients, sessions):
            kw_nonce = rng.generate_random(12)
            kw = AESGCM(s.key).encrypt(
                kw_nonce, content_key, b"kw" + bytes([s.role])
            )
            out.write(struct.pack(">Q", r.id))
            write_chunk(out, s.sid)
            write_chunk(out, kw_nonce + kw)
        write_chunk(out, gcm_nonce + ct)
        return out.getvalue()

    def _encrypt_bootstrap(self, recipients, plaintext, nonce) -> bytes:
        # One observable per per-recipient asymmetric wrap: the series
        # the stale-session tests (and the presession pump) watch to
        # prove a single cold peer no longer re-bootstraps a whole
        # group (tests/test_message_sessions.py).
        metrics.incr("crypto.session.bootstrap_wraps", len(recipients))
        # Fresh pairwise sessions for every recipient of this envelope.
        grants = io.BytesIO()
        new_sessions: list[tuple[int, _SessionOut, certmod.Certificate]] = []
        for r in recipients:
            sid = rng.generate_random(16)
            skey = rng.generate_random(32)
            grants.write(struct.pack(">Q", r.id))
            write_chunk(grants, sid)
            write_chunk(grants, _wrap_to(r, skey))
            new_sessions.append(
                (r.id, _SessionOut(sid, skey, _ROLE_INITIATOR), r)
            )

        inner = io.BytesIO()
        write_chunk(inner, plaintext)
        write_chunk(inner, nonce)
        write_chunk(inner, self.cert.serialize())
        write_chunk(inner, grants.getvalue())
        body = inner.getvalue()
        if self._is_ec:
            from bftkv_tpu_torch.crypto import ecdsa as _ecdsa

            sig = _ecdsa.sign(body, self.key)
        else:
            sig = rsa.sign(body, self.key)
        signed = io.BytesIO()
        signed.write(body)
        write_chunk(signed, sig)

        content_key = rng.generate_random(32)
        gcm_nonce = rng.generate_random(12)
        ct = AESGCM(content_key).encrypt(gcm_nonce, signed.getvalue(), None)

        out = io.BytesIO()
        out.write(bytes([_TAG_BOOTSTRAP]))
        out.write(struct.pack(">H", len(recipients)))
        for r in recipients:
            out.write(struct.pack(">Q", r.id))
            write_chunk(out, _wrap_to(r, content_key))
        write_chunk(out, gcm_nonce + ct)

        # Commit the new outbound sessions only after the envelope is
        # fully built (no half-granted state on failure), and mirror
        # them inbound so the peer's session-keyed *responses* decrypt.
        with self._lock:
            for rid, s, r in new_sessions:
                self._lru_put(self._by_peer, rid, s)
                # Self-addressed sessions (a node dealing a share to
                # itself, dsa_core) have one instance on both ends:
                # encrypt and decrypt must agree on the role, so the
                # inbound mirror keeps the *initiator* role and
                # _accept_grant skips self-grants.
                peer_role = (
                    _ROLE_INITIATOR if rid == self.cert.id else _ROLE_RESPONDER
                )
                self._lru_put(
                    self._by_id, s.sid, _SessionIn(s.key, r, peer_role)
                )
        return out.getvalue()

    # -- decrypt ----------------------------------------------------------

    def decrypt(self, data: bytes) -> tuple[bytes, certmod.Certificate, bytes]:
        """Returns (plaintext, sender_cert, nonce); the caller is
        responsible for deciding whether to trust ``sender_cert``
        (reference: transport decrypt → Server.Handler dispatch,
        http.go:143 → server.go:562)."""
        if not data:
            raise ERR_INVALID_TRANSPORT_SECURITY_DATA
        tag = data[0]
        if tag == _TAG_BOOTSTRAP:
            return self._decrypt_bootstrap(data[1:])
        if tag == _TAG_SESSION:
            return self._decrypt_session(data[1:])
        raise ERR_INVALID_TRANSPORT_SECURITY_DATA

    def _decrypt_session(self, data: bytes):
        r = io.BytesIO(data)
        hdr = r.read(2)
        if len(hdr) < 2:
            raise ERR_INVALID_TRANSPORT_SECURITY_DATA
        nrecip = struct.unpack(">H", hdr)[0]
        my = None
        try:
            for _ in range(nrecip):
                ib = r.read(8)
                if len(ib) < 8:
                    raise ERR_INVALID_TRANSPORT_SECURITY_DATA
                rid = struct.unpack(">Q", ib)[0]
                sid = read_chunk(r)
                kw = read_chunk(r)
                if rid == self.cert.id:
                    my = (sid, kw)
            blob = read_chunk(r)
        except Exception:
            raise ERR_INVALID_TRANSPORT_SECURITY_DATA from None
        if my is None or blob is None or len(blob) < 12:
            raise ERR_DECRYPTION_FAILURE
        sid, kw = my
        sid = sid or b""
        with self._lock:
            sess = self._by_id.get(sid)
            if sess is not None:
                self._by_id.move_to_end(sid)
        if sess is None:
            raise ERR_UNKNOWN_SESSION
        if kw is None or len(kw) < 12:
            raise ERR_DECRYPTION_FAILURE
        try:
            content_key = AESGCM(sess.key).decrypt(
                kw[:12], kw[12:], b"kw" + bytes([sess.peer_role])
            )
            inner = AESGCM(content_key).decrypt(blob[:12], blob[12:], b"data")
        except Exception:
            raise ERR_DECRYPTION_FAILURE from None
        sr = io.BytesIO(inner)
        try:
            plaintext = read_chunk(sr) or b""
            nonce = read_chunk(sr) or b""
        except Exception:
            raise ERR_INVALID_TRANSPORT_SECURITY_DATA from None
        return plaintext, sess.peer, nonce

    def _decrypt_bootstrap(self, data: bytes):
        r = io.BytesIO(data)
        hdr = r.read(2)
        if len(hdr) < 2:
            raise ERR_INVALID_TRANSPORT_SECURITY_DATA
        nrecip = struct.unpack(">H", hdr)[0]
        wrapped = None
        try:
            for _ in range(nrecip):
                ib = r.read(8)
                if len(ib) < 8:
                    raise ERR_INVALID_TRANSPORT_SECURITY_DATA
                rid = struct.unpack(">Q", ib)[0]
                wk = read_chunk(r)
                if rid == self.cert.id:
                    wrapped = wk
            blob = read_chunk(r)
        except Exception:
            raise ERR_INVALID_TRANSPORT_SECURITY_DATA from None
        if wrapped is None or blob is None or len(blob) < 12:
            raise ERR_DECRYPTION_FAILURE
        try:
            content_key = self._unwrap(wrapped)
            signed = AESGCM(content_key).decrypt(blob[:12], blob[12:], None)
        except Exception:
            raise ERR_DECRYPTION_FAILURE from None

        sr = io.BytesIO(signed)
        try:
            plaintext = read_chunk(sr) or b""
            nonce = read_chunk(sr) or b""
            cert_bytes = read_chunk(sr) or b""
            grant_bytes = read_chunk(sr) or b""
            body_end = sr.tell()
            sig = read_chunk(sr) or b""
        except Exception:
            raise ERR_INVALID_TRANSPORT_SECURITY_DATA from None
        try:
            senders = certmod.parse(cert_bytes)
        except Exception:
            raise ERR_INVALID_TRANSPORT_SECURITY_DATA from None
        if not senders:
            raise ERR_INVALID_TRANSPORT_SECURITY_DATA
        sender = senders[0]
        if not certmod.verify_detached(signed[:body_end], sig, sender):
            raise ERR_INVALID_SIGNATURE
        self._accept_grant(grant_bytes, sender)
        return plaintext, sender, nonce

    def _unwrap(self, wrapped: bytes) -> bytes:
        """Unwrap a key blob addressed to this identity (inverse of
        :func:`_wrap_to` for our own algorithm)."""
        if self._is_ec:
            from bftkv_tpu_torch.crypto import ecdsa as _ecdsa

            return _ecdsa.ecies_unwrap(wrapped, self.key)
        if self._priv is not None:
            return self._priv.decrypt(wrapped, _OAEP)
        return _oaep_unwrap_py(self.key, wrapped)

    def _accept_grant(self, grant_bytes: bytes, sender) -> None:
        """Install the session granted to *me* (if any). Grants are
        authenticated: they live inside the RSA-signed inner envelope."""
        if sender.id == self.cert.id:
            return  # self-grant: the encrypt-time mirror is authoritative
        gr = io.BytesIO(grant_bytes)
        try:
            while True:
                ib = gr.read(8)
                if len(ib) < 8:
                    return
                rid = struct.unpack(">Q", ib)[0]
                sid = read_chunk(gr) or b""
                wk = read_chunk(gr) or b""
                if rid != self.cert.id:
                    continue
                skey = self._unwrap(wk)
                with self._lock:
                    # A session id belongs to the pair that first used
                    # it: a Byzantine peer must not be able to overwrite
                    # an honest pair's inbound session by replaying its
                    # sid (the sid travels in cleartext on fast-path
                    # envelopes) in a grant of its own.
                    existing = self._by_id.get(sid)
                    if existing is not None and existing.peer.id != sender.id:
                        continue
                    self._lru_put(
                        self._by_id,
                        sid,
                        _SessionIn(skey, sender, _ROLE_INITIATOR),
                    )
                    self._lru_put(
                        self._by_peer,
                        sender.id,
                        _SessionOut(sid, skey, _ROLE_RESPONDER),
                    )
        except Exception:
            # A torn grant only means the fast path stays cold for this
            # pair; the carried payload was already authenticated.
            return
