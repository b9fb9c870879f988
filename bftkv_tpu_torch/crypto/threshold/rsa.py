"""Threshold RSA: k-of-n signing via combinatorial additive key splits
(counterpart of ``bftkv_tpu/crypto/threshold/rsa.py``).

Capability parity with the reference (crypto/threshold/rsa/rsa.go):

- the dealer splits the private exponent d **additively** along a tree —
  at each node the remaining fragment is re-split among the servers not
  on that node's path, to depth n-k — so *any* k-of-n subset's held
  fragments sum to d (``make_key_tree``/``split_key``, rsa.go:75-117);
- a server signs by exponentiating the EMSA-encoded message with each
  fragment it holds (negative fragments via modular inverse,
  rsa.go:140-178);
- the client walks a mirror ``_SigTree``, requests missing fragment ids,
  and multiplies partial signatures mod N once every branch completes
  (rsa.go:203-338).

"(7,10) seems practical" — fragment count grows combinatorially with
n-k (reference: docs/tex/method.tex:374-377).

A server's per-request fragment exponentiations — up to C(n-1, n-k)-ish
modexps with exponents that *grow past the key size* at each tree level —
go to ``BatchModExp.modexp`` as one batch instead of the Go reference's
sequential ``big.Int.Exp`` loop.  The widest exponent decides the route:
the split bound is 2^(2·bitlen) per level, so at 2048 bits a deal with
k < n holds fragments of 8185 bits and more, past ``MAX_EXP_LIMBS``
(4096 bits), and signs with host ``pow``; only an n-of-n deal (fragments
of about 4092 bits) takes the limb engine on the device.
"""

from __future__ import annotations

import hashlib
import io
import struct

from bftkv_tpu_torch.crypto import rsa as rsakeys
from bftkv_tpu_torch.errors import (
    ERR_INSUFFICIENT_NUMBER_OF_RESPONSES,
    ERR_MALFORMED_REQUEST,
    ERR_UNSUPPORTED_ALGORITHM,
)
from bftkv_tpu_torch.ops.modexp import BatchModExp
from bftkv_tpu_torch.packet import read_chunk, write_chunk

from bftkv_tpu_torch.crypto.threshold import ThresholdAlgo

__all__ = ["RSAThreshold"]

# DER DigestInfo prefixes (standard constants, PKCS#1 v1.5).
_HASH_PREFIXES = {
    "sha1": bytes.fromhex("3021300906052b0e03021a05000414"),
    "sha224": bytes.fromhex("302d300d06096086480165030402040500041c"),
    "sha256": bytes.fromhex("3031300d060960864801650304020105000420"),
    "sha384": bytes.fromhex("3041300d060960864801650304020205000430"),
    "sha512": bytes.fromhex("3051300d060960864801650304020305000440"),
}


# -- tree index arithmetic (reference: rsa.go:119-137, 256-263) -----------


def _depth(idx: int, n: int) -> int:
    d = 0
    while idx:
        idx = (idx - 1) // n
        d += 1
    return d


def _in_path(i: int, path: int, n: int) -> bool:
    while path:
        if i == (path - 1) % n:
            return True
        path = (path - 1) // n
    return False


def _split_key(d: int, parts: int, rng) -> list[int]:
    """Additive split into ``parts`` signed fragments summing to d
    (reference: rsa.go:97-117)."""
    bound = 1 << (d.bit_length() * 2)
    frags = []
    total = 0
    for _ in range(parts - 1):
        x = rng(bound)
        sign = x & 1
        x >>= 1
        if sign:
            x = -x
        frags.append(x)
        total += x
    frags.append(d - total)
    return frags


class _ParamTree:
    __slots__ = ("idx", "di", "children")

    def __init__(self, idx: int, di: int, children=None):
        self.idx = idx
        self.di = di
        self.children = children  # dict server_i -> _ParamTree | None


def make_key_tree(key: int, idx: int, n: int, k: int, rng) -> _ParamTree:
    """(reference: rsa.go:75-95)."""
    d = _depth(idx, n)
    if d > n - k:
        return _ParamTree(idx, key)
    frags = _split_key(key, n - d, rng)
    tree = _ParamTree(idx, key, {})
    j = 0
    for i in range(n):
        if _in_path(i, idx, n):
            continue
        tree.children[i] = make_key_tree(frags[j], idx * n + i + 1, n, k, rng)
        j += 1
    return tree


def collect_keys(tree: _ParamTree, i: int, keys: dict[int, int]) -> None:
    """Server i's fragments: child-i's value at every node where i is a
    child (reference: rsa.go:119-127)."""
    if not tree.children:
        return
    for j, child in tree.children.items():
        if j == i:
            keys[tree.idx] = child.di
        else:
            collect_keys(child, i, keys)


# -- EMSA (reference: rsa.go:345-378) -------------------------------------


def emsa_encode(prefix: bytes, dgst: bytes, em_len: int) -> int:
    mlen = len(prefix) + len(dgst)
    padlen = em_len - mlen
    if padlen < 3 + 8:  # 0x00 0x01 [8×0xff minimum] 0x00
        raise ERR_MALFORMED_REQUEST
    em = b"\x00\x01" + b"\xff" * (padlen - 3) + b"\x00" + prefix + dgst
    return int.from_bytes(em, "big")


def _i2os(v: int, size: int) -> bytes:
    b = v.to_bytes(max((v.bit_length() + 7) // 8, 1), "big")
    return b if len(b) >= size else b.rjust(size, b"\x00")


# -- wire formats (reference: rsa.go:383-520) ------------------------------


def _serialize_partial_param(
    keys: dict[int, int], n_mod: int, sid: int, n: int
) -> bytes:
    buf = io.BytesIO()
    buf.write(struct.pack(">H", len(keys)))
    for idx, frag in keys.items():
        buf.write(struct.pack(">I", idx))
        buf.write(bytes([1 if frag < 0 else 0]))
        write_chunk(buf, _i2os(abs(frag), 1))
    write_chunk(buf, _i2os(n_mod, 1))
    buf.write(struct.pack(">I", sid))
    buf.write(bytes([n]))
    return buf.getvalue()


def _parse_partial_param(data: bytes) -> tuple[dict[int, int], int, int, int]:
    try:
        r = io.BytesIO(data)
        (cnt,) = struct.unpack(">H", r.read(2))
        keys: dict[int, int] = {}
        for _ in range(cnt):
            (idx,) = struct.unpack(">I", r.read(4))
            sign = r.read(1)[0]
            frag = int.from_bytes(read_chunk(r) or b"", "big")
            keys[idx] = -frag if sign else frag
        n_mod = int.from_bytes(read_chunk(r) or b"", "big")
        (sid,) = struct.unpack(">I", r.read(4))
        n = r.read(1)[0]
        return keys, n_mod, sid, n
    except Exception:
        raise ERR_MALFORMED_REQUEST from None


def _serialize_sign_request(keys: list[int], hinfo: bytes) -> bytes:
    buf = io.BytesIO()
    buf.write(struct.pack(">H", len(keys)))
    for kid in keys:
        buf.write(struct.pack(">I", kid))
    write_chunk(buf, hinfo)
    return buf.getvalue()


def _parse_sign_request(req: bytes) -> tuple[list[int], bytes, bytes]:
    try:
        r = io.BytesIO(req)
        (cnt,) = struct.unpack(">H", r.read(2))
        keys = [struct.unpack(">I", r.read(4))[0] for _ in range(cnt)]
        hinfo = read_chunk(r) or b""
        hr = io.BytesIO(hinfo)
        prefix = read_chunk(hr) or b""
        dgst = read_chunk(hr) or b""
        return keys, prefix, dgst
    except Exception:
        raise ERR_MALFORMED_REQUEST from None


def _serialize_hash_info(hash_name: str, tbs: bytes) -> bytes:
    prefix = _HASH_PREFIXES.get(hash_name)
    if prefix is None:
        raise ERR_UNSUPPORTED_ALGORITHM
    dgst = hashlib.new(hash_name, tbs).digest()
    buf = io.BytesIO()
    write_chunk(buf, prefix)
    write_chunk(buf, dgst)
    return buf.getvalue()


def _serialize_partial_signature(sigs: dict[int, int], n_mod: int) -> bytes:
    buf = io.BytesIO()
    buf.write(struct.pack(">H", len(sigs)))
    for idx, s in sigs.items():
        buf.write(struct.pack(">I", idx))
        write_chunk(buf, _i2os(s, 1))
    write_chunk(buf, _i2os(n_mod, 1))
    return buf.getvalue()


def _parse_partial_signature(data: bytes) -> tuple[dict[int, int], int]:
    try:
        r = io.BytesIO(data)
        (cnt,) = struct.unpack(">H", r.read(2))
        sigs: dict[int, int] = {}
        for _ in range(cnt):
            (idx,) = struct.unpack(">I", r.read(4))
            sigs[idx] = int.from_bytes(read_chunk(r) or b"", "big")
        n_mod = int.from_bytes(read_chunk(r) or b"", "big")
        return sigs, n_mod
    except Exception:
        raise ERR_MALFORMED_REQUEST from None


# -- client signature tree (reference: rsa.go:203-338) ---------------------


class _SigTree:
    __slots__ = ("idx", "psig", "completed", "children")

    def __init__(self, idx: int, psig: int | None = None, completed: bool = False):
        self.idx = idx
        self.psig = psig
        self.completed = completed
        self.children: dict[int, _SigTree] | None = None


def _missing_keys(st: _SigTree | None, keys: list[int], n: int, k: int) -> list[int]:
    if st is None or st.completed:
        return keys
    if not st.children:
        keys.append(st.idx)
        return keys
    if _depth(st.idx, n) >= n - k:
        return keys
    for i in range(n):
        if _in_path(i, st.idx, n):
            continue
        c = st.children.get(i)
        if c is None:
            keys.append(st.idx * n + i + 1)
        elif not c.completed:
            _missing_keys(c, keys, n, k)
    return keys


def _register_partial_signature(
    st: _SigTree, idx: int, psig: int, d: int, n: int
) -> None:
    self_idx = idx
    for _ in range(d - 1):
        self_idx = (self_idx - 1) // n
    i = (self_idx - 1) % n
    if st.children is None:
        st.children = {}
    c = st.children.get(i)
    if c is None:
        if d <= 1:
            c = _SigTree(self_idx, psig, True)
        else:
            c = _SigTree(self_idx)
        st.children[i] = c
    if d > 1:
        _register_partial_signature(c, idx, psig, d - 1, n)
    if len(st.children) >= n - _depth(st.idx, n):
        st.completed = all(ch.completed for ch in st.children.values())


def _calculate_signature(st: _SigTree, acc: int, n_mod: int) -> int:
    if not st.completed:
        return acc
    if st.psig is not None:
        return (acc * st.psig) % n_mod
    for c in st.children.values():
        acc = _calculate_signature(c, acc, n_mod)
    return acc


class _RSAProcess:
    def __init__(self, nodes: list, n: int, k: int, hinfo: bytes):
        self.nodes = nodes
        self.n = n
        self.k = k
        self.tree = _SigTree(0)
        self.sig: bytes | None = None
        self.hinfo = hinfo

    def make_request(self) -> tuple[list | None, bytes | None]:
        """Minimal-transaction strategy: request exactly the fragment ids
        still missing, broadcast to all nodes in case failed ones return
        (reference: rsa.go:217-238)."""
        keys = _missing_keys(self.tree, [], self.n, self.k)
        if not keys:
            return None, None
        return self.nodes, _serialize_sign_request(keys, self.hinfo)

    def process_response(self, data: bytes, peer) -> bytes | None:
        sigs, n_mod = _parse_partial_signature(data)
        if self.sig is not None:
            return self.sig
        for idx, s in sigs.items():
            _register_partial_signature(
                self.tree, idx, s, _depth(idx, self.n), self.n
            )
        if self.tree.completed:
            s = _calculate_signature(self.tree, 1, n_mod)
            self.sig = _i2os(s, (n_mod.bit_length() + 7) // 8)
        return self.sig


class RSAThreshold:
    """(reference: rsa.go:29-72, 140-178)."""

    def __init__(self, crypt=None, rng=None, *, device=None):
        import secrets as pysecrets

        self.crypt = crypt
        self.nodes: list = []
        self.n = 0
        self.k = 0
        self._rng = rng or pysecrets.randbelow
        self._engine = BatchModExp.shared(device)

    def distribute(
        self, key: rsakeys.PrivateKey, nodes: list, k: int
    ) -> tuple[list[bytes], ThresholdAlgo]:
        self.nodes = list(nodes)
        self.n = len(nodes)
        self.k = k
        tree = make_key_tree(key.d, 0, self.n, k, self._rng)
        shares = []
        for i in range(self.n):
            keys: dict[int, int] = {}
            collect_keys(tree, i, keys)
            shares.append(_serialize_partial_param(keys, key.n, i, self.n))
        return shares, ThresholdAlgo.RSA

    def sign(
        self, sec: bytes, req: bytes | None, peer_id: int, self_id: int
    ) -> bytes | None:
        """One ``BatchModExp`` batch over every requested fragment."""
        kids, prefix, dgst, = _parse_sign_request(req or b"")
        keys, n_mod, sid, n = _parse_partial_param(sec)
        m = emsa_encode(prefix, dgst, (n_mod.bit_length() + 7) // 8)
        held = [(kid, keys[kid]) for kid in kids if kid in keys]
        if not held:
            return None
        powers = self._engine.modexp([(m, abs(di)) for _, di in held], n_mod)
        sigs: dict[int, int] = {}
        for (kid, di), ci in zip(held, powers):
            if di < 0:
                ci = pow(ci, -1, n_mod)
            sigs[kid * n + sid + 1] = ci
        return _serialize_partial_signature(sigs, n_mod)

    def new_process(
        self, tbs: bytes, algo: ThresholdAlgo, hash_name: str
    ) -> _RSAProcess:
        """The client can't EMSA-encode without N, so the request carries
        (prefix, digest) and servers encode (reference: rsa.go:199-215)."""
        hinfo = _serialize_hash_info(hash_name, tbs)
        if not self.nodes:
            raise ERR_INSUFFICIENT_NUMBER_OF_RESPONSES
        return _RSAProcess(self.nodes, self.n, self.k, hinfo)
