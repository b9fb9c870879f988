"""Client side of the port's shared crypto sidecar: drop-in crypto domains.

Counterpart of ``bftkv_tpu/crypto/remote_verify.py``, speaking the same
frames (:mod:`bftkv_tpu_torch.cmd.verify_sidecar`) with the same spot
checks, breaker and local fallback on SHED and ERR, so either package's
client works against either package's server.

One :class:`SidecarChannel` owns the persistent connection, the HMAC
framing, and the circuit breaker; the domains share it so a verdict of
dishonesty on ANY op benches the service for every op:

- :class:`RemoteVerifierDomain` — ``VerifierDomain`` drop-in;
  forwards verify batches (public data) and **spot-checks** verdicts
  locally at a sampled rate (``BFTKV_SIDECAR_SPOT_RATE``);
- :class:`RemoteSignerDomain` — ``SignerDomain`` drop-in; registers
  private keys as per-connection handles (only over the 0600 unix
  socket or the HMAC channel — never plain TCP) and **self-checks**
  every returned signature with the public exponent (cheap at
  e=65537);
- :class:`RemoteModexpDomain` — raw batched modexp with the same
  sampled local re-check.

The service is untrusted by construction: any check mismatch increments
``crypto.sidecar.dishonest``, opens the shared breaker, and the batch
re-runs on local crypto.  The two checks differ in strength: signing
is self-checked on EVERY item, so a forged
signature can never leave this process; verify/modexp verdicts are
*sampled*, so a lying sidecar has a bounded detection window
(expected ``1/spot_rate`` batches, then permanent local fallback) —
``BFTKV_SIDECAR_SPOT_RATE=1`` closes the window entirely.  Transport failures likewise degrade to
local crypto (``verify.remote_fallback`` / ``sign.remote_fallback``)
with the breaker open for ``BFTKV_SIDECAR_BREAKER`` seconds; an
admission SHED from the service falls back locally WITHOUT opening the
breaker (overload is not failure).

A tenant hands the domains to its dispatchers
(``VerifyDispatcher(verifier=RemoteVerifierDomain(addr))``,
``SignDispatcher(signer=RemoteSignerDomain(addr))``): the local
dispatchers still coalesce the process's own threads; the sidecar's
dispatchers then coalesce across processes.
"""

from __future__ import annotations

import hmac
import random
import socket
import struct
import time

import numpy as np

from bftkv_tpu_torch.cmd.verify_sidecar import (
    OP_MODEXP,
    OP_REGISTER,
    OP_SIGN,
    OP_STATS,
    OP_VERIFY,
    ST_BAD_HANDLE,
    ST_OK,
    ST_REFUSED,
    ST_SHED,
    TAG_LEN,
    _chunks,
    encode_modexp_request,
    encode_op,
    encode_register_request,
    encode_request,
    encode_sign_request,
    request_tag,
    response_tag,
    wrap_keys,
)
from bftkv_tpu_torch import flags, trace
from bftkv_tpu_torch.crypto import cert as certmod
from bftkv_tpu_torch.crypto import rsa
from bftkv_tpu_torch.devtools.lockwatch import named_lock
from bftkv_tpu_torch.metrics import registry as metrics

__all__ = [
    "SidecarChannel",
    "RemoteVerifierDomain",
    "RemoteSignerDomain",
    "RemoteModexpDomain",
]


class SidecarChannel:
    """One persistent connection + breaker, shared by the domains.

    ``request`` returns ``(status, payload)`` or ``None`` on transport
    failure (after one transparent reconnect retry), in which case the
    breaker opens — a hung sidecar would otherwise stall every flush.
    ``trip()`` opens it explicitly (protocol skew, dishonest result).
    ``generation`` counts (re)connects: per-connection server state —
    sign-key handles — is invalid whenever it changes."""

    def __init__(
        self,
        addr: str,
        *,
        timeout: float = 30.0,
        secret: bytes | None = None,
        breaker_seconds: float | None = None,
    ):
        if addr.startswith("unix:"):
            self._addr: tuple | str = addr[len("unix:"):]
        else:
            host, _, port = addr.rpartition(":")
            self._addr = (host or "127.0.0.1", int(port))
        self._timeout = timeout
        self._secret = secret
        self.breaker_seconds = (
            breaker_seconds
            if breaker_seconds is not None
            else flags.get_float("BFTKV_SIDECAR_BREAKER")
        )
        #: True when this channel may carry private-key material: the
        #: unix socket (mode 0600, same uid) or HMAC-keyed TCP.  A
        #: plain TCP port can be squatted after a sidecar crash, so
        #: signing stays local there by policy.
        self.carries_keys = isinstance(self._addr, str) or secret is not None
        self._lock = named_lock("crypto.remote_verify")
        self._sock: socket.socket | None = None
        self._skip_until = 0.0
        self.generation = 0

    # -- breaker ----------------------------------------------------------

    def tripped(self) -> bool:
        return time.monotonic() < self._skip_until

    def trip(self) -> None:
        self._skip_until = time.monotonic() + self.breaker_seconds
        metrics.incr("verify.remote_breaker_open")

    def reset(self) -> None:
        """Forget an open breaker (tests, operator recovery)."""
        self._skip_until = 0.0

    # -- transport --------------------------------------------------------

    def _connect(self) -> socket.socket:
        if isinstance(self._addr, str):
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(self._timeout)
            s.connect(self._addr)
            return s
        s = socket.create_connection(self._addr, timeout=self._timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def request(self, op: int, payload: bytes) -> tuple[int, bytes] | None:
        """One v2 round trip.  ``None`` = transport failure (breaker
        now open); otherwise the authenticated ``(status, payload)``."""
        if self.tripped():
            return None
        if trace.capture() is not None:
            # Inside a request trace, the shared-service round trip is
            # its own budget phase — a slow write queueing behind
            # another tenant's batch shows up HERE, not as mystery
            # "server" time.
            with trace.span(
                "sidecar.call",
                attrs={"op": op, "bytes": len(payload)},
            ):
                return self._request(op, payload)
        return self._request(op, payload)

    def _request(self, op: int, payload: bytes) -> tuple[int, bytes] | None:
        body = encode_op(op, payload)
        if self._secret is not None:
            body += request_tag(self._secret, body)
        frame = struct.pack(">I", len(body)) + body
        with self._lock:
            for _attempt in range(2):
                try:
                    if self._sock is None:
                        self._sock = self._connect()
                        self.generation += 1
                    self._sock.sendall(frame)
                    out = self._read_response(body)
                    if out is not None:
                        return out
                except (ConnectionError, OSError, struct.error):
                    pass
                # Broken pipe / sidecar restart: drop the connection
                # and retry once on a fresh one before giving up.
                self._close_locked()
            self.trip()
        return None

    def _read_response(self, req_body: bytes) -> tuple[int, bytes] | None:
        hdr = self._recvall(4)
        (ln,) = struct.unpack(">I", hdr)
        if ln > (1 << 26):
            raise ConnectionError("oversized sidecar response")
        body = self._recvall(ln)
        if self._secret is not None:
            if len(body) < TAG_LEN:
                # An old (v1-only) server answers a v2 frame with a
                # short untagged all-fail reply; fail to local crypto.
                return None
            out, tag = body[:-TAG_LEN], body[-TAG_LEN:]
            # The request body the tag covers excludes our own tag.
            if not hmac.compare_digest(
                tag, response_tag(self._secret, req_body[:-TAG_LEN], out)
            ):
                # Forged/replayed verdicts (port squatter): fail closed.
                metrics.incr("verify.remote_bad_mac")
                raise ConnectionError("sidecar response MAC mismatch")
            body = out
        if len(body) < 1:
            return None  # v1-era zero-length internal-error reply
        return body[0], body[1:]

    def _recvall(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            part = self._sock.recv(n - len(buf))
            if not part:
                raise ConnectionError("sidecar closed")
            buf += part
        return buf

    def _close_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    def seal_keys(self, payload: bytes) -> bytes:
        """REGISTER payloads are AEAD-sealed under the shared secret on
        TCP — the frame tag authenticates but does not hide, and the
        client sends keys before any byte proves the peer holds the
        secret.  The unix socket carries them plain (kernel 0600)."""
        if self._secret is None:
            return payload
        return wrap_keys(self._secret, payload)

    def stats(self) -> dict | None:
        """The service's stats frame (None on any failure)."""
        import json

        resp = self.request(OP_STATS, b"")
        if resp is None or resp[0] != ST_OK:
            return None
        try:
            return json.loads(resp[1])
        except Exception:
            return None


class RemoteVerifierDomain:
    """Forward verify batches to the sidecar; local fallback on failure.

    The default local fallback is a HOST-ONLY verifier (on the ``cpu``,
    never launching): a sidecar-mode daemon deliberately does not own
    the accelerator (the sidecar does), so its degradation path must not
    try to initialize one.  Pass ``local=`` explicitly for a
    device-capable fallback: ``VerifierDomain(device="cuda:0")``, whose
    batches of EC P-256 items (which never ride the RSA-shaped wire) then
    run kernel K5 in the tenant.

    Verdicts are spot-checked: at ``BFTKV_SIDECAR_SPOT_RATE`` (per
    batch) one sampled item is re-verified locally, and a mismatch
    opens the breaker, raises ``crypto.sidecar.dishonest``, and
    re-verifies the whole batch locally — the mismatching batch never
    leaves this function with remote verdicts.  UNSAMPLED batches are
    returned as-is, so a lying sidecar is caught in expectation within
    ``1/rate`` batches but may steer verdicts until then: the
    detection window is the deliberate trade, and ``spot_rate=1``
    closes it (every batch re-verified locally)."""

    #: After a remote failure, skip the sidecar for this long — a hung
    #: (connected but unresponsive) sidecar would otherwise stall every
    #: flush for up to two timeouts, serializing the dispatcher.
    #: ``None`` = read ``BFTKV_SIDECAR_BREAKER`` (the default); set the
    #: class attribute to a number to pin it (tests).
    BREAKER_SECONDS: float | None = None

    def __init__(
        self,
        addr: str = "",
        *,
        timeout: float = 30.0,
        local=None,
        secret: bytes | None = None,
        channel: SidecarChannel | None = None,
        spot_rate: float | None = None,
    ):
        # With the default (host-only) fallback, EC items must also stay
        # on host: this process deliberately does not own an accelerator.
        self._ec_host_only = local is None
        self.channel = channel or SidecarChannel(
            addr,
            timeout=timeout,
            secret=secret,
            breaker_seconds=self.BREAKER_SECONDS,
        )
        self.spot_rate = (
            spot_rate
            if spot_rate is not None
            else flags.get_float("BFTKV_SIDECAR_SPOT_RATE")
        )
        self._rng = random.Random()
        self.local = local or rsa.VerifierDomain(host_threshold=1 << 30, device="cpu")
        # The protocol layer reads the crossover off the domain; the
        # sidecar amortizes launches remotely, so keep the local
        # VerifierDomain's usual crossover semantics for callers.
        self.host_threshold = rsa.VerifierDomain.HOST_CROSSOVER

    def verify_batch(self, items: list) -> np.ndarray:
        # Hostile public keys (oversized e, absurd n) must fail closed
        # per item like the local path — not blow up the whole frame.
        # ECDSA P-256 items never ride the (RSA-shaped) sidecar wire:
        # they go to the local domain's batched EC verifier.
        wire_idx: list[int] = []
        wire_items: list = []
        out_all = np.zeros((len(items),), dtype=bool)
        local_idx: list[int] = []
        ec_idx: list[int] = []
        for i, (msg, sig, key) in enumerate(items):
            if certmod.is_ec(key):
                ec_idx.append(i)
            elif 0 < key.e < (1 << 32) and key.n > 0:
                wire_idx.append(i)
                wire_items.append((msg, sig, key))
            else:
                local_idx.append(i)
        if ec_idx:
            if self._ec_host_only:
                from bftkv_tpu_torch.crypto import ecdsa as _ecdsa

                for i in ec_idx:
                    try:
                        m, s, k = items[i]
                        out_all[i] = _ecdsa.verify_host(m, s, k)
                    except Exception:
                        out_all[i] = False
            else:
                out_all[np.asarray(ec_idx)] = np.asarray(
                    self.local.verify_batch([items[i] for i in ec_idx]),
                    dtype=bool,
                )
        for i in local_idx:
            try:
                msg, sig, key = items[i]
                out_all[i] = rsa.verify_host(msg, sig, key)
            except Exception:
                out_all[i] = False
        if not wire_items:
            return out_all
        got = self._verify_remote(wire_items)
        if got is not None:
            got = self._spot_check(wire_items, got)
        if got is None:
            metrics.incr("verify.remote_fallback", len(wire_items))
            got = self.local.verify_batch(wire_items)
        out_all[np.asarray(wire_idx)] = np.asarray(got, dtype=bool)
        return out_all

    def _spot_check(self, items: list, got: np.ndarray):
        """Sampled local re-verification of one remote verdict; a
        mismatch means a dishonest (or broken) sidecar: bench it and
        return None so the caller re-verifies the batch locally."""
        if self.spot_rate <= 0 or self._rng.random() >= self.spot_rate:
            return got
        i = self._rng.randrange(len(items))
        msg, sig, key = items[i]
        try:
            want = rsa.verify_host(msg, sig, key)
        except Exception:
            want = False
        metrics.incr("verify.spot_check")
        if bool(got[i]) == want:
            return got
        metrics.incr("crypto.sidecar.dishonest")
        self.channel.trip()
        return None

    def _verify_remote(self, items: list) -> np.ndarray | None:
        resp = self.channel.request(OP_VERIFY, encode_request(items))
        if resp is None:
            return None
        status, payload = resp
        if status == ST_SHED:
            # Admission shed: overload, not failure — fall back local
            # for THIS batch without benching the service.
            metrics.incr("verify.remote_shed")
            return None
        if status != ST_OK or len(payload) != len(items):
            # Internal error or protocol skew: local verify, and bench
            # the service so a broken accelerator cannot stall flushes.
            self.channel.trip()
            return None
        metrics.incr("verify.remote", len(items))
        return np.frombuffer(payload, dtype=np.uint8).astype(bool)

    def _close(self) -> None:
        self.channel.close()


class RemoteSignerDomain:
    """``SignerDomain`` drop-in that outsources RSA signing.

    Keys are registered once per connection (handles); messages then
    cross the wire with a 4-byte handle each.  EVERY returned signature
    is self-checked with the public exponent before release — ~17
    modmuls against the ~1280 the sidecar paid, so outsourcing keeps
    its asymmetry while a forged or faulted signature can never leave
    this process (it would both leak nothing — PKCS#1 v1.5 is
    deterministic — and be caught here, re-signed locally, with the
    breaker open and ``crypto.sidecar.dishonest`` raised)."""

    def __init__(
        self,
        addr: str = "",
        *,
        timeout: float = 30.0,
        secret: bytes | None = None,
        channel: SidecarChannel | None = None,
    ):
        self.channel = channel or SidecarChannel(
            addr, timeout=timeout, secret=secret
        )
        self.enabled = flags.enabled("BFTKV_SIDECAR_SIGN")
        #: SignDispatcher start() may consult this; the remote domain
        #: decides host/remote internally, so keep every batch size.
        self.host_threshold = 0
        self._lock = named_lock("crypto.remote_sign")
        self._handles: dict[int, int] = {}  # key.n -> handle
        self._handles_gen = -1
        self._refused = False

    def sign_batch(self, items: list) -> list:
        """[(message, key)] → [signature bytes]; remote with local
        fallback, self-checked."""
        out: list = [None] * len(items)
        wire_idx: list[int] = []
        for i, (msg, key) in enumerate(items):
            if certmod.is_ec(key):
                from bftkv_tpu_torch.crypto import ecdsa as _ecdsa

                out[i] = _ecdsa.sign(msg, key)
            else:
                wire_idx.append(i)
        if not wire_idx:
            return out
        witems = [items[i] for i in wire_idx]
        sigs = None
        if (
            self.enabled
            and self.channel.carries_keys
            and not self._refused
            and not self.channel.tripped()
        ):
            sigs = self._sign_remote(witems)
            if sigs is not None:
                sigs = self._self_check(witems, sigs)
            if sigs is None:
                metrics.incr("sign.remote_fallback", len(witems))
        if sigs is None:
            sigs = [rsa.sign(msg, key) for msg, key in witems]
            metrics.incr("sign.host", len(witems))
        for i, sig in zip(wire_idx, sigs):
            out[i] = sig
        return out

    def _self_check(self, witems: list, sigs: list) -> list | None:
        for (msg, key), sig in zip(witems, sigs):
            ok = False
            try:
                ok = bool(sig) and rsa.verify_host(msg, sig, key.public)
            except Exception:
                ok = False
            if not ok:
                # A forged/faulted signature: the service is dishonest
                # or broken either way — bench it and re-sign the whole
                # batch locally (deterministic PKCS#1 v1.5: the local
                # signature is THE signature).
                metrics.incr("crypto.sidecar.dishonest")
                self.channel.trip()
                return None
        return sigs

    def _sign_remote(self, witems: list) -> list | None:
        with self._lock:
            for _attempt in range(2):
                if not self._ensure_registered(witems):
                    return None
                payload = encode_sign_request(
                    [(self._handles[key.n], msg) for msg, key in witems]
                )
                resp = self.channel.request(OP_SIGN, payload)
                if resp is None:
                    return None
                status, body = resp
                if status == ST_BAD_HANDLE:
                    # Sidecar restarted between our register and sign
                    # (or the reconnect raced): handles are per-
                    # connection state — drop them and re-register.
                    self._handles.clear()
                    continue
                if status == ST_SHED:
                    metrics.incr("sign.remote_shed")
                    return None
                if status != ST_OK:
                    self.channel.trip()
                    return None
                try:
                    sigs = _chunks(body, len(witems))
                except Exception:
                    self.channel.trip()
                    return None
                metrics.incr("sign.remote", len(witems))
                return sigs
            return None

    def _ensure_registered(self, witems: list) -> bool:
        if self._handles_gen != self.channel.generation:
            # New connection: the server-side handle table died with
            # the old one.
            self._handles.clear()
            self._handles_gen = self.channel.generation
        missing: list = []
        seen: set = set()
        for _msg, key in witems:
            if key.n not in self._handles and key.n not in seen:
                seen.add(key.n)
                missing.append(key)
        if not missing:
            return True
        resp = self.channel.request(
            OP_REGISTER,
            self.channel.seal_keys(encode_register_request(missing)),
        )
        if resp is None:
            return False
        status, body = resp
        if status == ST_REFUSED:
            # Registration is closed for this connection — key-free
            # channel policy (plain TCP) or the per-connection key
            # budget is spent.  Permanent: sign locally, keep remoting
            # verify, never trip the shared breaker over it.
            self._refused = True
            metrics.incr("sign.remote_refused")
            return False
        if status != ST_OK or len(body) < 4:
            self.channel.trip()
            return False
        (count,) = struct.unpack(">I", body[:4])
        if count != len(missing) or len(body) < 4 + 4 * count:
            self.channel.trip()
            return False
        handles = struct.unpack(">%dI" % count, body[4 : 4 + 4 * count])
        # The register round trip may have reconnected under us; the
        # handles belong to whatever connection answered it.
        self._handles_gen = self.channel.generation
        for key, h in zip(missing, handles):
            self._handles[key.n] = h
        metrics.incr("sign.remote_register", count)
        return True


class RemoteModexpDomain:
    """Raw batched modexp through the sidecar, locally re-checked at
    the sampled rate (one recompute per sampled batch — the only
    oracle a generic modexp has is itself, so the spot-check pays one
    local op to keep the service honest in expectation)."""

    def __init__(
        self,
        addr: str = "",
        *,
        timeout: float = 30.0,
        secret: bytes | None = None,
        channel: SidecarChannel | None = None,
        spot_rate: float | None = None,
    ):
        self.channel = channel or SidecarChannel(
            addr, timeout=timeout, secret=secret
        )
        self.spot_rate = (
            spot_rate
            if spot_rate is not None
            else flags.get_float("BFTKV_SIDECAR_SPOT_RATE")
        )
        self._rng = random.Random()

    def powmod_batch(self, items: list) -> list:
        """[(base, exp, mod)] → [int], falling back to local ``pow``."""
        if not items:
            return []
        vals = None
        if not self.channel.tripped():
            vals = self._remote(items)
        if vals is None:
            metrics.incr("modexp.remote_fallback", len(items))
            return [pow(b, e, m) for b, e, m in items]
        if self.spot_rate > 0 and self._rng.random() < self.spot_rate:
            i = self._rng.randrange(len(items))
            b, e, m = items[i]
            if vals[i] != pow(b, e, m):
                metrics.incr("crypto.sidecar.dishonest")
                self.channel.trip()
                metrics.incr("modexp.remote_fallback", len(items))
                return [pow(b, e, m) for b, e, m in items]
        metrics.incr("modexp.remote", len(items))
        return vals

    def powmod(self, base: int, exp: int, mod: int) -> int:
        return self.powmod_batch([(base, exp, mod)])[0]

    def _remote(self, items: list) -> list | None:
        resp = self.channel.request(
            OP_MODEXP, encode_modexp_request(items)
        )
        if resp is None:
            return None
        status, body = resp
        if status == ST_SHED:
            metrics.incr("modexp.remote_shed")
            return None
        if status != ST_OK:
            self.channel.trip()
            return None
        try:
            return [
                int.from_bytes(c, "big") for c in _chunks(body, len(items))
            ]
        except Exception:
            self.channel.trip()
            return None
