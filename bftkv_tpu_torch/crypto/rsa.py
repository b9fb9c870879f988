"""RSA primitives and the batched device domains of the port.

Counterpart of ``bftkv_tpu/crypto/rsa.py``.  Key generation, PKCS#1
v1.5 encoding, host signing and the host verify oracle are host Python
(``pow``); the native modexp loader waits for a later slice.  The
domains batch the replica's crypto onto the device:

- :class:`VerifierDomain` — RSA e=65537 verifies, by backend: ``rns``
  (default) through the RNS verify chain (kernel K1), ``limb`` through
  the limb Montgomery engine (PyTorch ops, :mod:`ops.rsa`), ``pallas``
  through the limb chain as kernel K3 (:mod:`ops.cuda_mont`);
- :class:`SignerDomain` — CRT signing, both halves of every signature as
  rows of one modexp launch: ``rns`` (default) on kernel K2, ``limb`` on
  the limb engine's ``power_batch``; then the Boneh–DeMillo–Lipton fault
  check as one more K1 launch plus a host spot check.

``BFTKV_VERIFY_BACKEND`` / ``BFTKV_SIGN_BACKEND`` pick the backend when
the caller names none, as in the reference.  EC keys raise
``NotImplementedError`` naming the slice that brings them.  On
``device="cuda"`` a kernel error propagates: it is never answered by the
CPU or by another backend.
"""

from __future__ import annotations

import hashlib
import logging
import random
import secrets
import subprocess
import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from bftkv_tpu_torch import device as devmod
from bftkv_tpu_torch import flags
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.ops import bigint, cuda_mont, devbuf, limb
from bftkv_tpu_torch.ops import rsa as rsa_ops

log = logging.getLogger("bftkv_tpu_torch.crypto.rsa")

# DigestInfo prefix for SHA-256 (RFC 8017 §9.2 note 1).
_SHA256_PREFIX = bytes.fromhex("3031300d060960864801650304020105000420")

F4 = 65537


class InvalidSignature(ValueError):
    """The message cannot carry a PKCS#1 v1.5 signature of this size."""


@dataclass
class PublicKey:
    n: int
    e: int = F4

    @property
    def size_bytes(self) -> int:
        return (self.n.bit_length() + 7) // 8


@dataclass
class PrivateKey:
    n: int
    e: int
    d: int
    p: int
    q: int

    @property
    def public(self) -> PublicKey:
        return PublicKey(n=self.n, e=self.e)

    @property
    def size_bytes(self) -> int:
        return (self.n.bit_length() + 7) // 8


# -- key generation -----------------------------------------------------------


def generate(bits: int = 2048, *, seed: int | None = None) -> PrivateKey:
    """Generate an RSA key (setup path, never hot).

    With ``seed`` the key is drawn from ``random.Random(seed)`` and is
    reproducible — for benchmarks and smoke runs, never for real keys.
    Without it: the ``openssl`` CLI, else the pure-Python generator on
    the ``secrets`` source.
    """
    if seed is not None:
        return _generate_py(bits, random.Random(seed))
    try:
        return _generate_openssl(bits)
    except (OSError, subprocess.SubprocessError, ValueError):
        return _generate_py(bits, secrets.SystemRandom())


def _der_tlv(data: bytes, off: int) -> tuple[bytes, int]:
    """Value bytes of the TLV at ``off`` plus the offset just past it."""
    if off + 2 > len(data):
        raise ValueError("der: truncated")
    length = data[off + 1]
    off += 2
    if length & 0x80:
        nlen = length & 0x7F
        if nlen == 0 or off + nlen > len(data):
            raise ValueError("der: bad length")
        length = int.from_bytes(data[off : off + nlen], "big")
        off += nlen
    if off + length > len(data):
        raise ValueError("der: truncated value")
    return data[off : off + length], off + length


def _der_ints(data: bytes) -> list[int]:
    """INTEGERs of one DER SEQUENCE (flat walk)."""
    if not data or data[0] != 0x30:
        raise ValueError("der: not a SEQUENCE")
    body, _ = _der_tlv(data, 0)
    out: list[int] = []
    off = 0
    while off < len(body):
        tag = body[off]
        val, off = _der_tlv(body, off)
        if tag == 0x02:
            out.append(int.from_bytes(val, "big"))
    return out


def _pem_der(pem: bytes, marker: bytes) -> bytes:
    import base64

    start = pem.index(b"-----BEGIN " + marker + b"-----")
    end = pem.index(b"-----END " + marker + b"-----")
    return base64.b64decode(b"".join(pem[start:end].splitlines()[1:]))


def _generate_openssl(bits: int) -> PrivateKey:
    pem = subprocess.run(
        ["openssl", "genrsa", str(bits)],
        capture_output=True, check=True, timeout=120,
    ).stdout
    if b"BEGIN RSA PRIVATE KEY" in pem:  # PKCS#1 (openssl 1.x)
        der = _pem_der(pem, b"RSA PRIVATE KEY")
    else:  # PKCS#8 (openssl 3.x): the key rides in an OCTET STRING
        der = _pem_der(pem, b"PRIVATE KEY")
        body, _ = _der_tlv(der, 0)
        off = 0
        while off < len(body):
            tag = body[off]
            val, off = _der_tlv(body, off)
            if tag == 0x04:
                der = val
                break
        else:
            raise ValueError("pkcs8: no key octet string")
    ints = _der_ints(der)  # version, n, e, d, p, q, dP, dQ, qInv
    if len(ints) < 6:
        raise ValueError("pkcs1: short key")
    _v, n, e, d, p, q = ints[:6]
    return PrivateKey(n=n, e=e, d=d, p=p, q=q)


def _is_probable_prime(n: int, rng, rounds: int = 40) -> bool:
    if n < 2:
        return False
    for sp in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47):
        if n % sp == 0:
            return n == sp
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = rng.randrange(2, n - 1)
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _gen_prime(bits: int, rng, avoid: int = 0) -> int:
    while True:
        p = rng.getrandbits(bits) | (1 << (bits - 1)) | (1 << (bits - 2)) | 1
        if p != avoid and p % F4 != 1 and _is_probable_prime(p, rng):
            return p


def _generate_py(bits: int, rng) -> PrivateKey:
    while True:
        p = _gen_prime(bits // 2, rng)
        q = _gen_prime(bits - bits // 2, rng, avoid=p)
        n = p * q
        if n.bit_length() != bits:
            continue
        try:
            d = pow(F4, -1, (p - 1) * (q - 1))
        except ValueError:
            continue
        return PrivateKey(n=n, e=F4, d=d, p=p, q=q)


# -- PKCS#1 v1.5 and the host oracle ------------------------------------------


def emsa_pkcs1v15_sha256(message: bytes, em_len: int) -> int:
    """EMSA-PKCS1-v1_5 encoding of SHA-256(message), as an integer."""
    t = _SHA256_PREFIX + hashlib.sha256(message).digest()
    if em_len < len(t) + 11:
        raise InvalidSignature("modulus too short for PKCS#1 v1.5 SHA-256")
    em = b"\x00\x01" + b"\xff" * (em_len - len(t) - 3) + b"\x00" + t
    return int.from_bytes(em, "big")


def _crt_pow_d(c: int, key) -> int:
    """``c^d mod n`` via CRT with host ``pow``."""
    m1 = pow(c, key.d % (key.p - 1), key.p)
    m2 = pow(c, key.d % (key.q - 1), key.q)
    h = (pow(key.q, -1, key.p) * (m1 - m2)) % key.p
    return m2 + h * key.q


def sign(message: bytes, key) -> bytes:
    """PKCS#1 v1.5 signature over SHA-256(message), CRT on the host."""
    m = emsa_pkcs1v15_sha256(message, key.size_bytes)
    return _crt_pow_d(m, key).to_bytes(key.size_bytes, "big")


def verify_host(message: bytes, sig: bytes, key) -> bool:
    """Host oracle verify (off the hot path, and the tests' reference)."""
    s = int.from_bytes(sig, "big")
    if s >= key.n:
        return False
    return pow(s, key.e, key.n) == emsa_pkcs1v15_sha256(message, key.size_bytes)


def _is_ec(key) -> bool:
    """The reference's algorithm rule (``crypto/cert.py::is_ec``)."""
    return hasattr(key, "curve")


def _backend(backend: str | None, flag: str, allowed: tuple[str, ...]) -> str:
    """The caller's backend, else the flag's value (default ``rns``), as
    the reference's domains read it."""
    backend = backend or flags.raw(flag, "rns")
    if backend not in allowed:
        raise ValueError(f"unknown backend {backend!r} (one of {', '.join(allowed)})")
    return backend


def _no_ec() -> NotImplementedError:
    return NotImplementedError(
        "EC P-256 keys arrive with the EC slice (ROADMAP M8); "
        "this slice ports RSA only"
    )


class SignerDomain:
    """Batched PKCS#1 v1.5 signing on the device via CRT.

    Each signature is two half-width modexps (mod p and mod q); both
    halves of every signature ride as rows of one modexp launch — the RNS
    kernel K2 (``backend="rns"``) or the limb engine's ``power_batch``
    (``backend="limb"``, and RNS groups whose moduli the bases decline) —
    followed by a host-side CRT recombination and the fault check.  Below
    ``host_threshold`` items, and for keys no Montgomery domain takes,
    the host signs directly.
    """

    HOST_CROSSOVER = 16
    _CACHE_MAX = 1024  # distinct private keys in one trust domain: few

    def __init__(
        self,
        host_threshold: int | None = None,
        backend: str | None = None,
        *,
        device=None,
    ):
        self.device = devmod.resolve(device)
        if host_threshold is None:
            host_threshold = int(
                flags.raw("BFTKV_HOST_SIGN_THRESHOLD", self.HOST_CROSSOVER)
            )
        self.host_threshold = host_threshold
        self.backend = _backend(backend, "BFTKV_SIGN_BACKEND", ("rns", "limb"))
        self._doms = bigint.DomainCache(self._CACHE_MAX)
        self._crt: "OrderedDict[int, tuple[int, int, int]]" = OrderedDict()
        self._lock = threading.Lock()

    def _crt_params(self, key) -> tuple[int, int, int]:
        with self._lock:
            p = self._crt.get(key.n)
            if p is not None:
                self._crt.move_to_end(key.n)
                return p
        p = (key.d % (key.p - 1), key.d % (key.q - 1), pow(key.q, -1, key.p))
        with self._lock:
            self._crt[key.n] = p
            if len(self._crt) > self._CACHE_MAX:
                self._crt.popitem(last=False)
        return p

    def _sign_group_rns(self, w: int, group: list, out: list) -> bool:
        """One RNS modexp launch for a width group.  Returns False
        (leaving ``out`` untouched) when a modulus cannot take the RNS
        path; kernel errors propagate."""
        from bftkv_tpu_torch.ops import rns as rns_ops

        bases: list[int] = []
        exps: list[int] = []
        mods: list[int] = []
        for _i, key, m, _domp, _domq, dp, dq, _qinv in group:
            bases += [m, m]
            exps += [dp, dq]
            mods += [key.p, key.q]
        vals = rns_ops.power_mod_rns(
            bases, exps, mods, n_bits=w * 16, device=self.device
        )
        if vals is None:
            return False
        self._finish_group(group, vals, out)
        return True

    def _sign_group_limb(self, w: int, group: list, out: list) -> None:
        """One limb ``power_batch`` for a width group: rows are the CRT
        halves with their own modulus, padded to a power of two (floor
        32) with copies of row 0, as the reference pads."""
        rows = []  # (base, exponent, domain) per CRT half
        for _i, key, m, domp, domq, dp, dq, _qinv in group:
            rows += [(m % key.p, dp, domp), (m % key.q, dq, domq)]
        k = len(rows)
        rows += [rows[0]] * (max(32, 1 << (k - 1).bit_length()) - k)
        res = rsa_ops.power_batch(
            limb.ints_to_limbs([b for b, _e, _d in rows], w),
            limb.ints_to_limbs([e for _b, e, _d in rows], w),
            np.stack([d.n for _b, _e, d in rows]),
            np.stack([d.n_prime for _b, _e, d in rows]),
            np.stack([d.r2 for _b, _e, d in rows]),
            np.stack([d.one_mont for _b, _e, d in rows]),
            device=self.device,
        )
        self._finish_group(group, limb.limbs_to_ints(res[:k].cpu().numpy()), out)

    def _finish_group(self, group: list, vals: list[int], out: list) -> None:
        """CRT recombination of the device's halves, then the fault check."""
        metrics.incr("sign.device", len(group))
        sigs: list[tuple[int, object, int]] = []  # (item idx, key, s)
        for j, (i, key, m, _domp, _domq, _dp, _dq, qinv) in enumerate(group):
            m1, m2 = vals[2 * j], vals[2 * j + 1]
            h = (qinv * (m1 - m2)) % key.p
            sigs.append((i, key, m2 + h * key.q))
        # Fault check (Boneh–DeMillo–Lipton): one silently wrong CRT half
        # would let any observer factor the modulus via gcd(s^e − em, n).
        # Verify every output before release and re-sign faulted items
        # on the host.
        ok = self._fault_check(sigs, group)
        for (i, key, s), good, g in zip(sigs, ok, group):
            if good:
                out[i] = s.to_bytes(key.size_bytes, "big")
            else:
                metrics.incr("sign.fault")
                log.error("%s sign fault check failed; re-signing on host", self.backend)
                # Straight pow, no CRT: the most fault-immune route.
                out[i] = pow(g[2], key.d, key.n).to_bytes(key.size_bytes, "big")

    def _fault_check(self, sigs: list, group: list) -> list[bool]:
        """s^65537 ≡ em (mod n) for every produced signature, as one RNS
        verify launch where the moduli allow, host ``pow`` otherwise."""
        from bftkv_tpu_torch.ops import rns as rns_ops

        ems = [g[2] for g in group]
        ctx = rns_ops.context()
        unique: dict[int, int] = {}
        urows: list = []
        idxs: list[int] = []
        dev_s: list[int] = []
        dev_em: list[int] = []
        device_pos: list[int] = []
        ok = [False] * len(sigs)
        for pos, ((_i, key, s), em) in enumerate(zip(sigs, ems)):
            kr = ctx.key_rows(key.n) if key.e == F4 else None
            if kr is None:
                ok[pos] = pow(s, key.e, key.n) == em
                continue
            u = unique.get(key.n)
            if u is None:
                u = unique[key.n] = len(urows)
                urows.append(kr)
            idxs.append(u)
            dev_s.append(s)
            dev_em.append(em)
            device_pos.append(pos)
        if device_pos:
            good = rns_ops.verify_e65537_rns_indexed(
                dev_s, dev_em, idxs, urows, device=self.device
            )
            for pos, g in zip(device_pos, good):
                ok[pos] = bool(g)
            # The check shares the device with the sign it polices; spot
            # check one random item per batch on the host, so a
            # correlated device defect cannot stay hidden.
            spot = device_pos[secrets.randbelow(len(device_pos))]
            _i, skey, sval = sigs[spot]
            host_ok = pow(sval, skey.e, skey.n) == ems[spot]
            if host_ok != ok[spot]:
                metrics.incr("sign.fault_check_divergence")
                log.error("device fault check diverged from host spot check")
                ok[spot] = ok[spot] and host_ok
        return ok

    def sign_batch(self, items: list[tuple[bytes, "PrivateKey"]]) -> list[bytes]:
        """[(message, key)] → [signature bytes], batched on the device."""
        out: list[bytes | None] = [None] * len(items)
        by_width: dict[int, list] = {}
        host_idx: list[int] = []
        if any(_is_ec(key) for _m, key in items):
            raise _no_ec()
        if len(items) < self.host_threshold:
            host_idx = list(range(len(items)))
        else:
            for i, (message, key) in enumerate(items):
                w = max(
                    limb.nlimbs_for_bits(key.p.bit_length()),
                    limb.nlimbs_for_bits(key.q.bit_length()),
                )
                domp, domq = self._doms.get(key.p, w), self._doms.get(key.q, w)
                if domp is None or domq is None:
                    host_idx.append(i)
                    continue
                m = emsa_pkcs1v15_sha256(message, key.size_bytes)
                dp, dq, qinv = self._crt_params(key)
                by_width.setdefault(w, []).append((i, key, m, domp, domq, dp, dq, qinv))
        for w, group in by_width.items():
            if self.backend == "rns" and self._sign_group_rns(w, group, out):
                continue
            # backend="limb", or a modulus the RNS bases cannot take
            # (shares a channel prime): the limb engine signs the group.
            self._sign_group_limb(w, group, out)
        for i in host_idx:
            out[i] = sign(items[i][0], items[i][1])
        if host_idx:
            metrics.incr("sign.host", len(host_idx))
        return out  # type: ignore[return-value]


class VerifierDomain:
    """Batched RSA e=65537 verification on the device.

    Keys that cannot ride the device path — another exponent, or a hostile
    modulus (even, too wide, or, on ``rns``, sharing a factor with a
    channel prime) — are checked by the host oracle and fail closed; they
    never raise out of the verification path.  On ``rns`` a signature
    ≥ n also goes to the host; the limb backends carry it as s = 0,
    which never verifies, as the reference does.
    """

    _CACHE_MAX = 4096  # moduli are attacker-influenced (embedded certs)

    #: Below this many items a batch verifies on host (0 forces every
    #: item through the kernel: tests, profiling).
    HOST_CROSSOVER = 192

    def __init__(
        self,
        nlimbs: int = 128,
        host_threshold: int | None = None,
        backend: str | None = None,
        *,
        device=None,
    ):
        self.device = devmod.resolve(device)
        self.nlimbs = nlimbs
        if host_threshold is None:
            host_threshold = int(
                flags.raw("BFTKV_HOST_VERIFY_THRESHOLD", self.HOST_CROSSOVER)
            )
        self.host_threshold = host_threshold
        self.backend = _backend(
            backend, "BFTKV_VERIFY_BACKEND", ("rns", "limb", "pallas")
        )
        if self.backend == "pallas" and nlimbs != cuda_mont.L:
            raise ValueError(
                f"backend 'pallas' verifies 2048-bit moduli only "
                f"(nlimbs={cuda_mont.L}), not nlimbs={nlimbs}"
            )
        self._doms = bigint.DomainCache(self._CACHE_MAX)

    def assemble(self, items: list[tuple[bytes, bytes, PublicKey]]) -> tuple[np.ndarray, ...]:
        """items = [(message, sig, key)] → the (batch, nlimbs) digit arrays
        sig, em, n, n′, r2 of the limb backends.

        Every key must have e = 65537 and a Montgomery-compatible modulus
        (``verify_batch`` pre-filters; direct callers own that check).
        """
        sigs, ems, ns, nps, r2s = [], [], [], [], []
        for message, sig_bytes, key in items:
            dom = self._doms.get(key.n, self.nlimbs)
            s = int.from_bytes(sig_bytes, "big")
            if s >= key.n:
                s = 0  # forces a mismatch; keeps shapes static
            em = emsa_pkcs1v15_sha256(message, key.size_bytes)
            sigs.append(limb.int_to_limbs(s, self.nlimbs))
            ems.append(limb.int_to_limbs(em, self.nlimbs))
            ns.append(dom.n)
            nps.append(dom.n_prime)
            r2s.append(dom.r2)
        return tuple(np.stack(a) for a in (sigs, ems, ns, nps, r2s))

    def verify_batch(self, items: list[tuple[bytes, bytes, PublicKey]]) -> np.ndarray:
        """[(message, sig, key)] → (batch,) bool."""
        out = np.zeros((len(items),), dtype=bool)
        device_idx: list[int] = []
        device_items: list[tuple[bytes, bytes, PublicKey]] = []
        for i, (message, sig_bytes, key) in enumerate(items):
            if _is_ec(key):
                raise _no_ec()
            # 512-bit floor keeps the PKCS#1 encoding well-defined.
            if (key.e == F4 and key.n.bit_length() >= 512
                    and self._doms.get(key.n, self.nlimbs) is not None):
                device_idx.append(i)
                device_items.append((message, sig_bytes, key))
            else:
                # Host oracle for odd exponents; fails closed on junk keys.
                try:
                    out[i] = key.n > 0 and verify_host(message, sig_bytes, key)
                except (ValueError, ZeroDivisionError):
                    out[i] = False
        if device_items and len(device_items) < self.host_threshold:
            metrics.incr("verify.host", len(device_items))
            for j, (message, sig_bytes, key) in zip(device_idx, device_items):
                out[j] = verify_host(message, sig_bytes, key)
        elif device_items and self.backend == "rns":
            self._verify_rns(device_idx, device_items, out)
        elif device_items:
            self._verify_limb(device_idx, device_items, out)
        return out

    def _verify_limb(self, device_idx, device_items, out) -> None:
        """The ``limb`` and ``pallas`` backends: one launch for every item.
        Power-of-two buckets (floor 256, a multiple of K3's 256-row tile);
        pad rows carry sig = 0 against row 0's em and key, which never
        verifies, and are sliced off."""
        k = len(device_items)
        metrics.incr("verify.device", k)
        padded = max(256, 1 << (k - 1).bit_length())
        if self.backend == "pallas":
            self._verify_pallas(device_idx, device_items, out, padded)
            return
        sig, em, n, npr, r2 = (
            np.concatenate([a, np.broadcast_to(
                a[0] if j else np.zeros_like(a[0]), (padded - k,) + a.shape[1:]
            )])
            for j, a in enumerate(self.assemble(device_items))
        )
        with metrics.timer("verify.launch"):
            ok = rsa_ops.verify_batch_e65537(sig, em, n, npr, r2, device=self.device)
            out[np.asarray(device_idx)] = ok.cpu().numpy()[:k]

    def _verify_pallas(self, device_idx, device_items, out, padded: int) -> None:
        """K3 on operands staged in a slot of the ``mont`` ring: sig and em
        as the 16-bit digits of their little-endian bytes (s ≥ n as 0),
        n, n′ and r2 gathered from one row per distinct key."""
        from bftkv_tpu_torch.ops import rns

        unique: dict[int, int] = {}
        doms, idx, sigs, ems = [], [], [], []
        for message, sig_bytes, key in device_items:
            u = unique.get(key.n)
            if u is None:
                u = unique[key.n] = len(doms)
                doms.append(self._doms.get(key.n, self.nlimbs))
            idx.append(u)
            s = int.from_bytes(sig_bytes, "big")
            sigs.append(s if s < key.n else 0)  # s = 0 never verifies
            ems.append(emsa_pkcs1v15_sha256(message, key.size_bytes))
        k = len(device_items)
        names = ("sig", "em", "n", "nprime", "r2")
        spec = {name: ((padded, cuda_mont.L), torch.int32) for name in names}
        spec["ok"] = ((padded,), torch.bool)
        with metrics.timer("verify.launch"):
            lease = devbuf.lease(f"mont:{padded}:{self.device}", spec, self.device, width="mont")
            with lease.launch() as slot:
                for name, vals in (("sig", sigs), ("em", ems)):
                    a = slot[name]
                    a[:k] = rns.bytes_rows(vals, 2 * cuda_mont.L).view("<u2")
                    a[k:] = 0 if name == "sig" else a[0]
                for name, attr in (("n", "n"), ("nprime", "n_prime"), ("r2", "r2")):
                    a = slot[name]
                    a[:k] = np.stack([getattr(d, attr) for d in doms])[idx]
                    a[k:] = a[0]
                d = slot.upload(names)
                slot.download("ok", cuda_mont.verify_cuda(*(d[name] for name in names)))
            out[np.asarray(device_idx)] = lease.collect(lambda s: s["ok"][:k].copy())

    def _verify_rns(self, device_idx, device_items, out) -> None:
        """RNS device path with per-item host fallback for incapable keys.
        Key rows are deduplicated on the host and gathered on the device."""
        from bftkv_tpu_torch.ops import rns

        ctx = rns.context()
        unique: dict[int, int] = {}
        urows: list = []
        idxs, sigs, ems, keep_idx = [], [], [], []
        for j, (message, sig_bytes, key) in zip(device_idx, device_items):
            kr = ctx.key_rows(key.n)
            s = int.from_bytes(sig_bytes, "big")
            if kr is None or s >= key.n:
                # Hostile modulus (or oversized sig): host oracle, failing
                # closed on junk.
                metrics.incr("verify.host")
                try:
                    out[j] = s < key.n and verify_host(message, sig_bytes, key)
                except (ValueError, ZeroDivisionError):
                    out[j] = False
                continue
            u = unique.get(key.n)
            if u is None:
                u = unique[key.n] = len(urows)
                urows.append(kr)
            idxs.append(u)
            sigs.append(s)
            ems.append(emsa_pkcs1v15_sha256(message, key.size_bytes))
            keep_idx.append(j)
        if not idxs:
            return
        metrics.incr("verify.device", len(idxs))
        with metrics.timer("verify.launch"):
            ok = rns.verify_e65537_rns_indexed(sigs, ems, idxs, urows, device=self.device)
        out[np.asarray(keep_idx)] = ok
