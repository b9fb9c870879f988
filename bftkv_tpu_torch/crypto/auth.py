"""Threshold password authentication (TPA) (counterpart of
``bftkv_tpu/crypto/auth.py``).

Capability parity with the reference's 3-round PAKE-like protocol
(reference: crypto/auth/auth.go:117-399, docs/tex/tpa.tex):

- setup: a random secret S is Shamir-shared across n servers; server i
  holds ``(x_i, y_i, v_i = g_π^{S·s_i}, salt_i)`` where
  ``s_i = H(password, salt_i)`` (auth.go:117-154);
- phase 0: client sends ``X = g_π^a``; each server answers
  ``Y_i = X^{y_i}``; once k arrive the client Lagrange-combines them into
  ``g_S = g_π^{aS}`` (auth.go:196-199, 294-329, 386-399);
- phase 1: per-server DH — client sends ``X_i = g_S^{a'_i·s_i}``, server
  answers ``B_i = v_i^{b_i}`` and both derive ``K_i``; HKDF key schedule,
  HMAC confirmation tag ``N_i`` (auth.go:201-222, 331-360);
- phase 2: server releases its AES-GCM-encrypted proof only if the MAC
  verifies (auth.go:224-237, 362-383).

Anti-brute-force: +1 s delay per retry, 10-attempt cap (auth.go:73-77,
176-184).

Redesign: the group is the RFC 3526 2048-bit MODP safe prime (a
public constant, *not* the reference's baked-in prime) and every modexp
routes through the shared batched engine
(:class:`bftkv_tpu_torch.ops.modexp.BatchModExp`) — the client's k-way
Lagrange combine and the k X_i computations each become one kernel
launch (K2 at 2048 bits) instead of k sequential ``big.Int.Exp`` calls
(SURVEY.md §2 hot loops).  The client, the servers and
:func:`generate_partial_auth_params` take ``device`` (``None``:
``cuda:0``; ``"cpu"``: the plain versions) for that engine.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import io
import os
import secrets as pysecrets
import struct
import time
from collections import OrderedDict
from dataclasses import dataclass, field

from bftkv_tpu_torch import device as devmod
from bftkv_tpu_torch.crypto import sss
from bftkv_tpu_torch.crypto.aead import AESGCM
from bftkv_tpu_torch.errors import (
    ERR_AUTHENTICATION_FAILURE,
    ERR_DECRYPTION_FAILURE,
    ERR_INVALID_RESPONSE,
    ERR_MALFORMED_REQUEST,
    ERR_NO_AUTHENTICATION_DATA,
    ERR_TOO_MANY_ATTEMPTS,
    Error,
)
from bftkv_tpu_torch.ops.modexp import BatchModExp
from bftkv_tpu_torch.packet import read_bigint, read_chunk, write_bigint, write_chunk

__all__ = [
    "AuthClient",
    "AuthServer",
    "AuthParams",
    "generate_partial_auth_params",
    "P",
    "Q",
]

# RFC 3526 group 14: 2048-bit MODP safe prime (p = 2q + 1).
P = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD1"
    "29024E088A67CC74020BBEA63B139B22514A08798E3404DD"
    "EF9519B3CD3A431B302B0A6DF25F14374FE1356D6D51C245"
    "E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3D"
    "C2007CB8A163BF0598DA48361C55D39A69163FA8FD24CF5F"
    "83655D23DCA3AD961C62F356208552BB9ED529077096966D"
    "670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9"
    "DE2BCBF6955817183995497CEA956AE515D2261898FA0510"
    "15728E5A8AACAA68FFFFFFFFFFFFFFFF",
    16,
)
Q = (P - 1) // 2

MAC_KEY_SIZE = 16
ENC_KEY_SIZE = 16

AUTH_DELAY_RATE = 1.0  # seconds added per retry (reference: auth.go:75)
AUTH_RETRY_LIMIT = 10  # (reference: auth.go:76)


def _hash(*args: bytes) -> bytes:
    h = hashlib.sha256()
    for a in args:
        h.update(a)
    return h.digest()


def pi_of(password: bytes) -> int:
    """Password → group element seed g_π (reference: auth.go:405-409)."""
    t = int.from_bytes(_hash(password), "big")
    return (t * t) % Q


def _modexp(pairs: list[tuple[int, int]], device) -> list[int]:
    """[(base, exp)] → [base^exp mod P] through the shared batched
    engine on ``device`` — the client's k-way Lagrange combine and X_i
    fan-out each become one kernel launch."""
    return BatchModExp.shared(device).modexp(pairs, P)


# -- key schedule / MAC / AEAD (reference: auth.go:529-578) ---------------


def _key_sched(ks: bytes, salt: bytes) -> tuple[bytes, bytes]:
    """HKDF-SHA256(ks, salt) → (mac_key, enc_key)."""
    prk = hmac_mod.new(salt, ks, hashlib.sha256).digest()
    okm = hmac_mod.new(prk, b"\x01", hashlib.sha256).digest()
    return okm[:MAC_KEY_SIZE], okm[MAC_KEY_SIZE : MAC_KEY_SIZE + ENC_KEY_SIZE]


def _calculate_mac(km: bytes, xi: bytes, bi: bytes) -> bytes:
    return hmac_mod.new(km, xi + bi, hashlib.sha256).digest()


def _encrypt(ke: bytes, plain: bytes, adata: bytes) -> tuple[bytes, bytes]:
    nonce = os.urandom(12)  # key is never reused
    return AESGCM(ke).encrypt(nonce, plain, adata), nonce


def _decrypt(ke: bytes, ciphertext: bytes, adata: bytes, nonce: bytes) -> bytes:
    return AESGCM(ke).decrypt(nonce, ciphertext, adata)


# -- wire formats (reference: auth.go:419-527) ----------------------------


@dataclass
class AuthParams:
    """One server's stored share of the auth secret."""

    x: int
    y: int
    v: int
    salt: bytes

    def serialize(self) -> bytes:
        buf = io.BytesIO()
        buf.write(struct.pack(">i", self.x))
        write_bigint(buf, self.y)
        write_bigint(buf, self.v)
        write_chunk(buf, self.salt)
        return buf.getvalue()

    @classmethod
    def parse(cls, data: bytes) -> "AuthParams":
        try:
            r = io.BytesIO(data)
            (x,) = struct.unpack(">i", r.read(4))
            y = read_bigint(r)
            v = read_bigint(r)
            salt = read_chunk(r) or b""
            return cls(x=x, y=y, v=v, salt=salt)
        except Exception:
            raise ERR_MALFORMED_REQUEST from None


def _serialize_yi(x: int, y: int, salt: bytes) -> bytes:
    buf = io.BytesIO()
    buf.write(struct.pack(">i", x))
    write_bigint(buf, y)
    write_chunk(buf, salt)
    return buf.getvalue()


def _parse_yi(data: bytes) -> tuple[int, int, bytes]:
    r = io.BytesIO(data)
    (x,) = struct.unpack(">i", r.read(4))
    y = read_bigint(r)
    salt = read_chunk(r) or b""
    return x, y, salt


def _serialize_bi(bi: int) -> bytes:
    buf = io.BytesIO()
    write_bigint(buf, bi)
    return buf.getvalue()


def _parse_bi(data: bytes) -> int:
    return read_bigint(io.BytesIO(data))


def _serialize_zi(zi: bytes, nonce: bytes) -> bytes:
    buf = io.BytesIO()
    write_chunk(buf, zi)
    write_chunk(buf, nonce)
    return buf.getvalue()


def _parse_zi(data: bytes) -> tuple[bytes, bytes]:
    r = io.BytesIO(data)
    zi = read_chunk(r) or b""
    nonce = read_chunk(r) or b""
    return zi, nonce


# -- setup (reference: auth.go:117-154) -----------------------------------


def generate_partial_auth_params(cred: bytes, n: int, k: int, *, device=None) -> list[bytes]:
    """Shamir-share a fresh secret S; server i gets
    ``(x_i, y_i, v_i = g_π^{S·s_i}, salt_i)``; the n exponentiations are
    one batch on ``device``."""
    s = pysecrets.randbelow(Q)
    coords = sss.distribute(s, n, k, Q)
    g_pi = pi_of(cred)
    salt = os.urandom(16)
    salts = [_hash(salt, bytes([i])) for i in range(n)]
    exps = []
    for i in range(n):
        si = int.from_bytes(_hash(cred, salts[i]), "big")
        exps.append((si * s) % Q)
    vs = _modexp([(g_pi, e) for e in exps], device)
    out = []
    for i in range(n):
        params = AuthParams(x=coords[i].x, y=coords[i].y, v=vs[i], salt=salts[i])
        out.append(params.serialize())
    return out


# -- server side (reference: auth.go:156-245) -----------------------------


class AuthServer:
    """Holds one variable's share; answers the three phases.

    One AuthServer lives as long as the stored auth data (the protocol
    server keeps it per protected variable), so the anti-brute-force
    counter spans client sessions (reference: auth.go:73-77,176-184).
    Per-session DH state (keys, MAC) is keyed by ``session`` — the
    caller passes a stable id per client connection — so concurrent
    logins don't clobber each other.
    """

    _MAX_SESSIONS = 1024

    def __init__(self, params_bytes: bytes, proof: bytes, *, sleep=time.sleep, device=None):
        self.device = devmod.resolve(device)
        self.params = AuthParams.parse(params_bytes)
        self.proof = proof
        self.attempts = 0
        # session -> (mac_key, enc_key, mac); LRU-bounded
        self._sessions: "OrderedDict[int, tuple[bytes, bytes, bytes]]" = (
            OrderedDict()
        )
        self._sleep = sleep

    def make_response(
        self, phase: int, req: bytes, session: int = 0
    ) -> tuple[bytes, bool]:
        """(response, done); raises on protocol violation."""
        try:
            if phase == 0:
                res = self._make_yi(req)
                delay = self.attempts * AUTH_DELAY_RATE
                if delay > 0:
                    self._sleep(delay)
                self.attempts += 1
                if self.attempts >= AUTH_RETRY_LIMIT:
                    raise ERR_TOO_MANY_ATTEMPTS
                return res, False
            if phase == 1:
                return self._make_bi(req, session), False
            if phase == 2:
                return self._make_zi(req, session), True
        except (ERR_TOO_MANY_ATTEMPTS, ERR_AUTHENTICATION_FAILURE):
            raise
        except Exception:
            raise ERR_MALFORMED_REQUEST from None
        raise ERR_MALFORMED_REQUEST

    def reset_attempts(self) -> None:
        """Successful authentication clears the retry penalty."""
        self.attempts = 0

    def _make_yi(self, x_bytes: bytes) -> bytes:
        x = int.from_bytes(x_bytes, "big")
        yi = pow(x, self.params.y, P)
        return _serialize_yi(self.params.x, yi, self.params.salt)

    def _make_bi(self, xi_bytes: bytes, session: int) -> bytes:
        b = pysecrets.randbelow(P)
        bi, ki = _modexp(
            [(self.params.v, b), (int.from_bytes(xi_bytes, "big"), b)], self.device
        )
        ki_bytes = ki.to_bytes((ki.bit_length() + 7) // 8, "big")
        km, ke = _key_sched(ki_bytes, self.params.salt)
        bi_bytes = bi.to_bytes((bi.bit_length() + 7) // 8, "big")
        mac = _calculate_mac(km, xi_bytes, bi_bytes)
        self._sessions[session] = (km, ke, mac)
        if len(self._sessions) > self._MAX_SESSIONS:
            self._sessions.popitem(last=False)
        return _serialize_bi(bi)

    def _make_zi(self, ni: bytes, session: int) -> bytes:
        state = self._sessions.get(session)
        if state is None or not hmac_mod.compare_digest(ni, state[2]):
            raise ERR_AUTHENTICATION_FAILURE
        _km, ke, mac = state
        zi, nonce = _encrypt(ke, self.proof, mac)
        return _serialize_zi(zi, nonce)


# -- client side (reference: auth.go:247-399) -----------------------------


@dataclass
class _PartialSecret:
    x: int
    y: int
    salt: bytes
    a2: int | None = None
    xi: bytes | None = None
    ni: bytes | None = None
    pi: bytes | None = None
    keys: tuple[bytes, bytes] | None = field(default=None)


class AuthClient:
    """Drives the three phases against n servers, combining k responses."""

    def __init__(self, cred: bytes, n: int, k: int, *, device=None):
        self.device = devmod.resolve(device)
        self.password = cred
        self.n = n
        self.k = k
        self.a: int | None = None
        self.gs: int | None = None
        self.secrets: dict[int, _PartialSecret] = {}
        # Per-phase dedup of responders; replays and stragglers from an
        # earlier phase must never count toward a later one.
        self._responded: dict[int, set[int]] = {1: set(), 2: set()}
        self._emitted: set[int] = set()

    def initiate(self, node_ids: list[int]) -> dict[int, bytes]:
        """Phase-0 request: the same X = g_π^a to every server."""
        self.a = pysecrets.randbelow(Q)
        x = pow(pi_of(self.password), self.a, P)
        xb = x.to_bytes((x.bit_length() + 7) // 8, "big")
        return {nid: xb for nid in node_ids}

    def done(self, phase: int) -> bool:
        return phase > 2

    def process_response(
        self, phase: int, data: bytes, peer_id: int
    ) -> dict[int, bytes] | None:
        """Feed one server's phase response; returns the next phase's
        per-server request map once enough responses are in.

        Responses come from mutually-distrusting servers: any malformed
        bytes fail closed as :data:`ERR_INVALID_RESPONSE`, never a raw
        parse exception."""
        try:
            if phase == 0:
                return self._process_yi(data, peer_id)
            if phase == 1:
                return self._process_bi(data, peer_id)
            if phase == 2:
                return self._process_zi(data, peer_id)
        except Error:
            raise
        except Exception:
            raise ERR_INVALID_RESPONSE from None
        raise ERR_INVALID_RESPONSE

    def get_cipher_key(self) -> bytes:
        """hash(g_π^S, password) — the symmetric key for value wrapping
        (reference: auth.go:285-292)."""
        if self.gs is None:
            raise ERR_NO_AUTHENTICATION_DATA
        a_inv = pow(self.a, -1, Q)
        gs = pow(self.gs, a_inv, P)
        return _hash(gs.to_bytes((gs.bit_length() + 7) // 8, "big"), self.password)

    # phase 0: collect Y_i, combine, emit X_i map
    def _process_yi(self, data: bytes, peer_id: int) -> dict[int, bytes] | None:
        if self.gs is not None:
            # Straggler after the k-th response: the shared secret and
            # per-server blinding are already fixed; recomputing them
            # here would invalidate the in-flight phase-1 state.
            return None
        x, yi, salt = _parse_yi(data)
        self.secrets[peer_id] = _PartialSecret(x=x, y=yi, salt=salt)
        if len(self.secrets) < self.k:
            return None
        self.gs = self._calculate_shared_secret()
        # X_i = g_S^{a'_i·s_i} for every server — one batched launch.
        ids = list(self.secrets)
        exps = []
        for nid in ids:
            sec = self.secrets[nid]
            sec.a2 = pysecrets.randbelow(Q)
            si = int.from_bytes(_hash(self.password, sec.salt), "big")
            exps.append((sec.a2 * si) % Q)
        xis = _modexp([(self.gs, e) for e in exps], self.device)
        out: dict[int, bytes] = {}
        for nid, xi in zip(ids, xis):
            xb = xi.to_bytes((xi.bit_length() + 7) // 8, "big")
            self.secrets[nid].xi = xb
            out[nid] = xb
        self._emitted.add(0)
        return out

    # phase 1: per-server DH confirm
    def _process_bi(self, data: bytes, peer_id: int) -> dict[int, bytes] | None:
        bi = _parse_bi(data)
        sec = self.secrets.get(peer_id)
        if sec is None:
            raise ERR_NO_AUTHENTICATION_DATA
        if 1 in self._emitted or peer_id in self._responded[1]:
            return None  # phase already complete, or a replay
        e = (self.a * sec.a2) % Q
        ki = pow(bi, e, P)
        ki_bytes = ki.to_bytes((ki.bit_length() + 7) // 8, "big")
        sec.keys = _key_sched(ki_bytes, sec.salt)
        bi_bytes = bi.to_bytes((bi.bit_length() + 7) // 8, "big")
        sec.ni = _calculate_mac(sec.keys[0], sec.xi, bi_bytes)
        self._responded[1].add(peer_id)
        if self._responded[1] >= set(self.secrets):
            self._emitted.add(1)
            return {nid: s.ni for nid, s in self.secrets.items()}
        return None

    # phase 2: decrypt proofs
    def _process_zi(self, data: bytes, peer_id: int) -> dict[int, bytes] | None:
        zi, nonce = _parse_zi(data)
        sec = self.secrets.get(peer_id)
        if sec is None:
            raise ERR_NO_AUTHENTICATION_DATA
        if 2 in self._emitted or peer_id in self._responded[2]:
            return None  # phase already complete, or a replay
        try:
            sec.pi = _decrypt(sec.keys[1], zi, sec.ni, nonce)
        except Exception:
            raise ERR_DECRYPTION_FAILURE from None
        self._responded[2].add(peer_id)
        if self._responded[2] >= set(self.secrets):
            self._emitted.add(2)
            return {nid: s.pi for nid, s in self.secrets.items()}
        return None

    def _calculate_shared_secret(self) -> int:
        """g_S = Π Y_i^{λ_i} — one batched kernel launch for the k
        exponentiations (reference: auth.go:386-399)."""
        xs = [s.x for s in self.secrets.values()]
        pairs = [
            (s.y, sss.lagrange(s.x, xs, Q)) for s in self.secrets.values()
        ]
        terms = _modexp(pairs, self.device)
        gs = 1
        for t in terms:
            gs = (gs * t) % P
        return gs
