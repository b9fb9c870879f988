"""Shared crypto sidecar of the port — one process owns the box's card.

Counterpart of ``bftkv_tpu/cmd/verify_sidecar.py``, wire protocol byte
for byte.  With several replica daemons (and edge gateways) co-located
on one accelerator host, per-process dispatchers each pay their own
device launches, kernel builds and transfers.  This sidecar is the
answer: ONE co-located service multiplexes every tenant's crypto —
verify, sign and raw modexp batches from all processes coalesce in its
dispatchers (``ops/dispatch.py``) into shared launches of the RNS
kernels K1 and K2 on its card (``--device``, default ``cuda:0``; each
launch split over every local card by ``ops/rns.py``), and only one
process builds and holds the kernels.  A device error is never answered
from the sidecar's own host crypto: the frame gets ST_ERR (a v1 frame a
zero-length reply), and the tenant falls back to its local crypto.

The service is **untrusted by construction** (verifiable
outsourcing): tenants self-check returned signatures with the
public exponent (cheap at e=65537) on EVERY item — a forged signature
can never leave a tenant — and spot-check verify/modexp verdicts
locally at a sampled rate, falling back to local crypto — with the
breaker open and ``crypto.sidecar.dishonest`` counted — on any
mismatch.  A lying service is therefore evicted within an
expected ``1/spot_rate`` batches; the sampled window is the tunable
trade, and ``BFTKV_SIDECAR_SPOT_RATE=1`` closes it.

Wire protocol (length-prefixed, one request per frame):

- **v1 (legacy verify)**: ``u32 count``, then per item ``chunk(msg)
  chunk(sig) chunk(n) u32 e``; response: count bytes of 0/1.  Kept
  bit-compatible for old clients.
- **v2 (op-tagged)**: ``u32 0xFFFFFFFF`` (impossible as a v1 count),
  ``u8 op``, payload.  Response: ``u8 status`` + payload.  Ops:
  VERIFY (v1 body), SIGN (``u32 count``, per item ``u32 handle``
  ``chunk(msg)``), REGISTER (``u32 count``, per key ``chunk(n) u32 e
  chunk(d) chunk(p) chunk(q)``), MODEXP (``u32 count``, per item
  ``chunk(base) chunk(exp) chunk(mod)``), STATS (empty → JSON stats
  frame).  Statuses: OK / SHED (admission declined — tenant falls
  back local WITHOUT opening its breaker) / ERR (internal failure —
  tenant falls back local and opens its breaker) / BAD_HANDLE (sign
  handle unknown, e.g. after a sidecar restart — tenant re-registers
  and retries once) / REFUSED (key registration declined for the
  connection's lifetime: a channel that must not carry keys, or the
  per-connection key budget spent — the client keeps signing locally
  and never asks again).

Sign keys are registered **per connection** as integer handles and are
accepted ONLY over the mode-0600 Unix socket or an HMAC-authenticated
channel — private material never crosses a squatter-able plain TCP
port (the client enforces the same policy and simply never remotes
signing there).

Backpressure: VERIFY/SIGN/MODEXP pass a bounded admission queue
(:class:`bftkv_tpu_torch.admission.AdmissionQueue`, the gateway's semantics) —
bounded inflight + bounded wait, instant shed past it with the
``sidecar.shed`` metric.  A shed tenant batch runs on the tenant's own
host crypto; the service degrades, it never queues unboundedly.

Failure semantics for v1 frames (deliberate, load-bearing):

- *Malformed frame* (attacker-controlled bytes): all-fail response of
  the claimed count — the client's accounting stays aligned and hostile
  input can never manufacture a "valid" verdict.
- *Internal error* (dispatcher/device failure): **zero-length
  response** — a count mismatch on the client side, which makes
  ``RemoteVerifierDomain`` fall back to local verification.  A broken
  accelerator must degrade to local verify, not masquerade as
  "all signatures invalid" (a cluster-wide liveness outage).

Trust boundary: results are checked by the tenants, but *liveness* and
key secrecy still require transport integrity, so the recommended
deployment is a **Unix domain socket** (``--listen unix:/path/sock``,
created mode 0600) — a TCP port can be squatted by any local user
after a sidecar crash.  For TCP, configure a shared secret
(``--secret-file``): every request and response carries an HMAC-SHA256
tag and the client fails closed (local crypto) on tag mismatch.

Run: ``python -m bftkv_tpu_torch.cmd.verify_sidecar --listen
unix:/run/bftkv/crypto.sock --stats 127.0.0.1:7960`` (``--device cpu``
serves from the host and the plain versions, for machines without a
card).  Tenants use :mod:`bftkv_tpu_torch.crypto.remote_verify`.
"""

from __future__ import annotations

import argparse
import hashlib
import hmac
import io
import json
import os
import socket
import socketserver
import struct
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from bftkv_tpu_torch import device as devmod
from bftkv_tpu_torch import flags, gcpolicy
from bftkv_tpu_torch.admission import AdmissionQueue
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.packet import read_chunk, write_chunk

__all__ = [
    "serve",
    "main",
    "encode_request",
    "decode_request",
    "encode_op",
    "encode_sign_request",
    "decode_sign_request",
    "encode_register_request",
    "decode_register_request",
    "encode_modexp_request",
    "decode_modexp_request",
    "request_tag",
    "response_tag",
    "SidecarService",
    "TAG_LEN",
    "MAGIC",
    "OP_VERIFY",
    "OP_SIGN",
    "OP_REGISTER",
    "OP_MODEXP",
    "OP_STATS",
    "ST_OK",
    "ST_SHED",
    "ST_ERR",
    "ST_BAD_HANDLE",
    "ST_REFUSED",
]

TAG_LEN = 32  # HMAC-SHA256

#: v2 frame marker: impossible as a v1 item count (> any max_frame).
MAGIC = b"\xff\xff\xff\xff"

OP_VERIFY = 1
OP_SIGN = 2
OP_REGISTER = 3
OP_MODEXP = 4
OP_STATS = 5

ST_OK = 0
ST_SHED = 1
ST_ERR = 2
ST_BAD_HANDLE = 3
ST_REFUSED = 4

_OP_NAMES = {OP_VERIFY: "verify", OP_SIGN: "sign", OP_MODEXP: "modexp"}


def request_tag(secret: bytes, body: bytes) -> bytes:
    return hmac.new(secret, b"bftkv-sidecar-req" + body, hashlib.sha256).digest()


def response_tag(secret: bytes, req_body: bytes, out: bytes) -> bytes:
    """Tag binds the verdicts to the exact request they answer, so a
    recorded response for one batch cannot be replayed for another."""
    h = hashlib.sha256(req_body).digest()
    return hmac.new(secret, b"bftkv-sidecar-res" + h + out, hashlib.sha256).digest()


# -- codecs (shared by client and server) -----------------------------------


def _int_bytes(v: int) -> bytes:
    return v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")


def encode_request(items: list) -> bytes:
    """[(message, sig_bytes, PublicKey)] → one VERIFY body (v1 shape)."""
    buf = io.BytesIO()
    buf.write(struct.pack(">I", len(items)))
    for message, sig, key in items:
        write_chunk(buf, message)
        write_chunk(buf, sig)
        write_chunk(buf, _int_bytes(key.n))
        buf.write(struct.pack(">I", key.e))
    return buf.getvalue()


def decode_request(body: bytes) -> list:
    from bftkv_tpu_torch.crypto.rsa import PublicKey

    r = io.BytesIO(body)
    (count,) = struct.unpack(">I", r.read(4))
    if count > len(body):  # each item needs headers at minimum
        raise ValueError("bad count")
    items = []
    for _ in range(count):
        msg = read_chunk(r) or b""
        sig = read_chunk(r) or b""
        n = int.from_bytes(read_chunk(r) or b"", "big")
        (e,) = struct.unpack(">I", r.read(4))
        items.append((msg, sig, PublicKey(n=n, e=e)))
    return items


def encode_op(op: int, payload: bytes = b"") -> bytes:
    """One v2 body: magic + op byte + payload."""
    return MAGIC + bytes([op]) + payload


def encode_sign_request(items: list) -> bytes:
    """[(handle, message)] → SIGN payload."""
    buf = io.BytesIO()
    buf.write(struct.pack(">I", len(items)))
    for handle, message in items:
        buf.write(struct.pack(">I", handle))
        write_chunk(buf, message)
    return buf.getvalue()


def decode_sign_request(payload: bytes) -> list:
    r = io.BytesIO(payload)
    (count,) = struct.unpack(">I", r.read(4))
    if count > len(payload):
        raise ValueError("bad count")
    items = []
    for _ in range(count):
        (handle,) = struct.unpack(">I", r.read(4))
        items.append((handle, read_chunk(r) or b""))
    return items


def encode_register_request(keys: list) -> bytes:
    """[PrivateKey] → REGISTER payload (n, e, d, p, q per key)."""
    buf = io.BytesIO()
    buf.write(struct.pack(">I", len(keys)))
    for k in keys:
        write_chunk(buf, _int_bytes(k.n))
        buf.write(struct.pack(">I", k.e))
        write_chunk(buf, _int_bytes(k.d))
        write_chunk(buf, _int_bytes(k.p))
        write_chunk(buf, _int_bytes(k.q))
    return buf.getvalue()


def decode_register_request(payload: bytes) -> list:
    from bftkv_tpu_torch.crypto.rsa import PrivateKey

    r = io.BytesIO(payload)
    (count,) = struct.unpack(">I", r.read(4))
    if count > len(payload):
        raise ValueError("bad count")
    keys = []
    for _ in range(count):
        n = int.from_bytes(read_chunk(r) or b"", "big")
        (e,) = struct.unpack(">I", r.read(4))
        d = int.from_bytes(read_chunk(r) or b"", "big")
        p = int.from_bytes(read_chunk(r) or b"", "big")
        q = int.from_bytes(read_chunk(r) or b"", "big")
        if not (1 < p < n and 1 < q < n and p * q == n and d > 0):
            raise ValueError("inconsistent private key")
        keys.append(PrivateKey(n=n, e=e, d=d, p=p, q=q))
    return keys


def wrap_keys(secret: bytes, payload: bytes) -> bytes:
    """AEAD-seal a REGISTER payload under the shared secret.

    The HMAC frame tags authenticate but do not HIDE: a squatter on a
    freed TCP port would otherwise read n/e/d/p/q out of the very first
    frame a reconnecting client sends — before any response proves the
    peer knows the secret.  Sealing makes captured key material
    worthless without the secret (the unix socket needs none of this:
    the kernel enforces mode 0600)."""
    from bftkv_tpu_torch.crypto.aead import AESGCM
    from bftkv_tpu_torch.crypto.rng import generate_random

    key = hashlib.sha256(b"bftkv-sidecar-keywrap" + secret).digest()
    nonce = generate_random(12)
    return nonce + AESGCM(key).encrypt(
        nonce, payload, b"bftkv-sidecar-register"
    )


def unwrap_keys(secret: bytes, wrapped: bytes) -> bytes:
    """Inverse of :func:`wrap_keys`; raises on tamper/garbage."""
    from bftkv_tpu_torch.crypto.aead import AESGCM

    if len(wrapped) < 12:
        raise ValueError("short keywrap")
    key = hashlib.sha256(b"bftkv-sidecar-keywrap" + secret).digest()
    return AESGCM(key).decrypt(
        wrapped[:12], wrapped[12:], b"bftkv-sidecar-register"
    )


def encode_modexp_request(items: list) -> bytes:
    """[(base, exp, mod)] → MODEXP payload."""
    buf = io.BytesIO()
    buf.write(struct.pack(">I", len(items)))
    for b, e, m in items:
        write_chunk(buf, _int_bytes(b))
        write_chunk(buf, _int_bytes(e))
        write_chunk(buf, _int_bytes(m))
    return buf.getvalue()


def decode_modexp_request(payload: bytes) -> list:
    r = io.BytesIO(payload)
    (count,) = struct.unpack(">I", r.read(4))
    if count > len(payload):
        raise ValueError("bad count")
    items = []
    for _ in range(count):
        b = int.from_bytes(read_chunk(r) or b"", "big")
        e = int.from_bytes(read_chunk(r) or b"", "big")
        m = int.from_bytes(read_chunk(r) or b"", "big")
        if m <= 0:
            raise ValueError("bad modulus")
        items.append((b, e, m))
    return items


def _chunks(payload: bytes, count: int) -> list:
    """``count`` length-prefixed chunks (sign/modexp response bodies)."""
    r = io.BytesIO(payload)
    out = []
    for _ in range(count):
        out.append(read_chunk(r) or b"")
    if r.read(1):
        raise ValueError("trailing bytes")
    return out


# -- the service ------------------------------------------------------------


class SidecarService:
    """Dispatchers + admission + stats for one sidecar process.

    Cross-tenant coalescing happens HERE: every connection handler
    thread submits into these shared dispatchers, so batches from
    different replica/gateway processes ride the same launches.  The
    measured host/device crossover of ``device`` steers each flush's
    tier *inside* the launch (``dispatch.calibration(device=…)``: a
    ``cuda`` device gets the device tier, the ``cpu`` pins always-host),
    while the dispatcher queue itself is never bypassed: occupancy must
    stay observable and tenants must keep coalescing even on a host-only
    box."""

    def __init__(
        self,
        *,
        max_batch: int = 4096,
        max_wait: float | None = None,
        admission: AdmissionQueue | None = None,
        device=None,
    ):
        from bftkv_tpu_torch.ops import dispatch

        self.device = devmod.resolve(device)
        cal = dispatch.calibration(device=self.device)
        # Host tier (CPU-calibrated box): there is no launch overhead
        # to amortize, so a collection window only adds latency —
        # cross-tenant coalescing still happens through concurrency (a
        # flush in service queues every arrival behind it).  On an
        # accelerator the usual windows amortize the launch RTT.
        host_tier = cal["prefer_host"]
        if max_wait is None and host_tier:
            max_wait = 0.0005
        kw = {} if max_wait is None else {"max_wait": max_wait}
        self.verify = dispatch.VerifyDispatcher(
            max_batch=max_batch, calibrate=False, device=self.device, **kw
        ).start()
        sign_wait = 0.0005 if host_tier else None
        # Host-tier flush bounds: a host sign is ~2 ms/item with no
        # launch to amortize, so a flush merging several tenants'
        # batches makes EACH wait for ALL (fair-share latency, minus
        # nothing).  Bounding the flush keeps FIFO-at-request latency;
        # on an accelerator the big merges ARE the win and the bounds
        # stay wide.
        sign_flush = 16 if host_tier else max_batch
        if host_tier:
            self.verify.max_batch = min(self.verify.max_batch, 256)
        self.sign = dispatch.SignDispatcher(
            max_batch=sign_flush, calibrate=False, max_wait=sign_wait,
            device=self.device,
        ).start()
        self.modexp = dispatch.ModexpDispatcher(
            max_batch=sign_flush,
            calibrate=False,
            device=self.device,
            **kw,
        ).start()
        self._cal: dict = {}
        self.apply_calibration(cal)
        # The process that owns the card serves every tenant's flushes:
        # the collector's policy holds while the service runs.
        gcpolicy.apply(self)
        self.admission = admission or AdmissionQueue(
            max_inflight=flags.get_int("BFTKV_SIDECAR_MAX_INFLIGHT"),
            max_queue=flags.get_int("BFTKV_SIDECAR_MAX_QUEUE"),
            max_wait=flags.get_float("BFTKV_SIDECAR_MAX_WAIT"),
            metric="sidecar.shed",
        )
        self.max_keys = flags.get_int("BFTKV_SIDECAR_MAX_KEYS")
        self._t0 = time.monotonic()
        # Online recalibration: the loop re-measures every
        # BFTKV_DISPATCH_RECAL_S seconds, and immediately after the
        # FIRST device launch completes (observed_launch_rtt turns
        # non-None), so the crossover follows what real flushes cost.
        self._recal_stop = threading.Event()
        self._recal_seen_rtt = False
        self._recal_thread: threading.Thread | None = None
        period = flags.get_float("BFTKV_DISPATCH_RECAL_S")
        if period and period > 0:
            self._recal_thread = threading.Thread(
                target=self._recal_loop, args=(period,), daemon=True
            )
            self._recal_thread.start()

    def apply_calibration(self, cal: dict) -> None:
        """(Re-)point the dispatchers' host/device thresholds at a
        calibration verdict — boot and every recalibration.  The tier
        decision lives inside each launch, so no dispatcher restart
        (and no caller disruption) is needed when the verdict moves.
        Note the sidecar intentionally does NOT adopt ``prefer_host``
        inline bypass: tenants must keep coalescing through the queue
        even on a host-only box (occupancy stays observable)."""
        from bftkv_tpu_torch.ops import dispatch

        if flags.raw("BFTKV_HOST_VERIFY_THRESHOLD") is None:
            self.verify.verifier.host_threshold = cal["verify_crossover"]
        if flags.raw("BFTKV_HOST_SIGN_THRESHOLD") is None:
            if cal["sign_crossover"] is not None:
                self.sign.signer.host_threshold = cal["sign_crossover"]
            elif self.sign._signer_default_threshold is not None:
                self.sign.signer.host_threshold = (
                    self.sign._signer_default_threshold
                )
        self.modexp.device_threshold = (
            dispatch.ALWAYS_HOST
            if cal["prefer_host"]
            else max(16, cal["verify_crossover"])
        )
        self._cal = cal

    def recalibrate(self) -> dict:
        """Force a fresh measurement and re-apply it (the
        ``/recalibrate`` devtools hook and the periodic loop)."""
        from bftkv_tpu_torch.ops import dispatch

        cal = dispatch.calibration(force=True, device=self.device)
        self.apply_calibration(cal)
        metrics.incr("sidecar.recalibrations")
        return cal

    def _recal_loop(self, period: float) -> None:
        from bftkv_tpu_torch.ops import dispatch

        next_at = time.monotonic() + period
        # Wake at min(period, 2 s): the periodic re-measure honors the
        # full period, but the first-successful-launch trigger should
        # not wait out a 60 s window to engage a device that just
        # proved itself.
        while not self._recal_stop.wait(timeout=min(period, 2.0)):
            rtt = dispatch.observed_launch_rtt()
            first_launch = rtt is not None and not self._recal_seen_rtt
            if first_launch:
                self._recal_seen_rtt = True
            if first_launch or time.monotonic() >= next_at:
                try:
                    self.recalibrate()
                except Exception:
                    metrics.incr("sidecar.recalibration_errors")
                next_at = time.monotonic() + period

    def stop(self) -> None:
        self._recal_stop.set()
        if self._recal_thread is not None:
            self._recal_thread.join(timeout=5)
            self._recal_thread = None
        self.verify.stop()
        self.sign.stop()
        self.modexp.stop()
        gcpolicy.release(self)

    def stats(self) -> dict:
        """The ``/metrics``-style stats frame (OP_STATS and the stats
        HTTP ``/info``): queue depth, per-dispatcher batch occupancy,
        shed, and per-op throughput counters."""
        snap = metrics.snapshot()
        inflight, waiting = self.admission.depth()

        def disp(name: str) -> dict:
            flushes = snap.get(f"{name}.flushes", 0)
            items = snap.get(f"{name}.items", 0)
            return {
                "flushes": flushes,
                "items": items,
                "occupancy_per_launch": round(items / flushes, 2)
                if flushes
                else None,
                "batch_p50": snap.get(f"{name}.batch.p50", 0),
                "throughput_items_per_s": round(
                    snap.get(f"{name}.throughput", 0), 1
                ),
            }

        from bftkv_tpu_torch.ops import devbuf, dispatch

        rtt = dispatch.observed_launch_rtt()
        return {
            "uptime_s": round(time.monotonic() - self._t0, 1),
            "queue": {
                "inflight": inflight,
                "waiting": waiting,
                "max_inflight": self.admission.max_inflight,
                "shed": self.admission.shed,
            },
            "ops": {
                name: snap.get("sidecar.items{op=%s}" % name, 0)
                for name in _OP_NAMES.values()
            },
            "batch": {
                "verify": disp("dispatch"),
                "sign": disp("signdispatch"),
                "modexp": disp("modexpdispatch"),
            },
            "device_plane": {
                "device": str(self.device),
                "calibration": {
                    k: self._cal.get(k)
                    for k in (
                        "backend",
                        "verify_crossover",
                        "prefer_host",
                        "source",
                    )
                },
                "launch_rtt_s": None if rtt is None else round(rtt, 6),
                "recalibrations": snap.get("sidecar.recalibrations", 0),
                "buffer_rings": devbuf.stats(),
            },
        }


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        sock = self.request
        secret = self.server.secret
        # Per-CONNECTION sign-key handles: a reconnect starts empty, so
        # a client that reconnects after a sidecar restart re-registers
        # (and a crashed client's keys die with its connection).
        conn_keys: dict = {}
        next_handle = [1]
        try:
            while True:
                hdr = _recvall(sock, 4)
                if hdr is None:
                    return
                (ln,) = struct.unpack(">I", hdr)
                if ln > self.server.max_frame:
                    return  # oversized frame: drop the connection
                body = _recvall(sock, ln)
                if body is None:
                    return
                if secret is not None:
                    # Unauthenticated peer: drop the connection. No
                    # all-fail reply — an attacker must not be able to
                    # steer verdicts at all without the secret.
                    if len(body) < TAG_LEN or not hmac.compare_digest(
                        body[-TAG_LEN:], request_tag(secret, body[:-TAG_LEN])
                    ):
                        return
                    body = body[:-TAG_LEN]
                if body[:4] == MAGIC and len(body) >= 5:
                    status, payload = self._handle_v2(
                        body[4], body[5:], conn_keys, next_handle
                    )
                    out = bytes([status]) + payload
                else:
                    out = self._handle_v1(body)
                tag = b"" if secret is None or not out else response_tag(
                    secret, body, out
                )
                sock.sendall(struct.pack(">I", len(out) + len(tag)) + out + tag)
        except (ConnectionError, OSError):
            return

    def _handle_v1(self, body: bytes) -> bytes:
        """Legacy verify frames, bit-compatible with old clients."""
        claimed = struct.unpack(">I", body[:4])[0] if len(body) >= 4 else 0
        try:
            items = decode_request(body)
        except Exception:
            # Malformed frame: all-fail response of the claimed count
            # keeps the client's accounting aligned (a hostile count is
            # already bounded by the frame).
            return bytes(min(claimed, len(body)))
        try:
            ok = self.server.dispatcher.verify(items)
            return bytes(bool(b) for b in ok)
        except Exception:
            # Internal failure (dead/hung accelerator, bug): zero-
            # length reply = count mismatch = client falls back to
            # LOCAL verification.  Never fabricate "all invalid" for
            # well-formed input.
            return b""

    def _handle_v2(
        self, op: int, payload: bytes, conn_keys: dict, next_handle: list
    ) -> tuple[int, bytes]:
        svc: SidecarService = self.server.service
        if op == OP_STATS:
            try:
                return ST_OK, json.dumps(svc.stats()).encode()
            except Exception:
                return ST_ERR, b""
        if op == OP_REGISTER:
            if not self.server.keys_ok:
                # Key material must only cross the 0600 unix socket or
                # the HMAC channel; plain TCP is refusable by policy
                # (the client never sends keys there either).
                return ST_REFUSED, b""
            try:
                if self.server.secret is not None:
                    # Key material on the HMAC channel arrives sealed
                    # (wrap_keys): the frame tag authenticates, the
                    # AEAD hides — see the client's register path.
                    payload = unwrap_keys(self.server.secret, payload)
                keys = decode_register_request(payload)
            except Exception:
                return ST_ERR, b""
            if len(conn_keys) + len(keys) > svc.max_keys:
                # Per-connection key budget spent (handles are add-only
                # while the connection lives): REFUSED, not ERR — the
                # client's refused-path is terminal for the connection
                # (signing stays local, verify keeps remoting), whereas
                # ERR would trip the shared breaker and re-trip it on
                # every register retry — a permanent flap that benches
                # verify too and spams sidecar_down anomalies.
                return ST_REFUSED, b""
            handles = []
            for k in keys:
                h = next_handle[0]
                next_handle[0] += 1
                conn_keys[h] = k
                handles.append(h)
            return ST_OK, struct.pack(">I", len(handles)) + b"".join(
                struct.pack(">I", h) for h in handles
            )
        opname = _OP_NAMES.get(op)
        if opname is None:
            return ST_ERR, b""
        if not svc.admission.acquire(opname):
            return ST_SHED, b""
        try:
            metrics.incr("sidecar.ops", labels={"op": opname})
            if op == OP_VERIFY:
                try:
                    items = decode_request(payload)
                except Exception:
                    return ST_ERR, b""
                metrics.incr(
                    "sidecar.items", len(items), labels={"op": opname}
                )
                ok = self.server.dispatcher.verify(items)
                return ST_OK, bytes(bool(b) for b in ok)
            if op == OP_SIGN:
                try:
                    pairs = decode_sign_request(payload)
                except Exception:
                    return ST_ERR, b""
                if any(h not in conn_keys for h, _m in pairs):
                    # Unknown handle: the canonical cause is a client
                    # that outlived a sidecar restart — it re-registers
                    # on its (new) connection and retries.
                    return ST_BAD_HANDLE, b""
                metrics.incr(
                    "sidecar.items", len(pairs), labels={"op": opname}
                )
                sigs = svc.sign.submit(
                    [(m, conn_keys[h]) for h, m in pairs]
                )
                buf = io.BytesIO()
                for sig in sigs:
                    write_chunk(buf, sig)
                return ST_OK, buf.getvalue()
            # OP_MODEXP
            try:
                items = decode_modexp_request(payload)
            except Exception:
                return ST_ERR, b""
            metrics.incr(
                "sidecar.items", len(items), labels={"op": opname}
            )
            vals = svc.modexp.submit(items)
            buf = io.BytesIO()
            for v in vals:
                write_chunk(buf, _int_bytes(v))
            return ST_OK, buf.getvalue()
        except Exception:
            # Internal failure: the status byte IS the signal — the
            # tenant falls back to local crypto and opens its breaker.
            return ST_ERR, b""
        finally:
            svc.admission.release()


def _recvall(sock, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            return None
        buf += part
    return buf


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True
    # socketserver listens with a backlog of 5.  A fleet's daemons open
    # their channels together on their first batch, and a connect to a
    # Unix socket whose backlog is full fails at once (EAGAIN) where TCP
    # would retry: the tenant then trips its breaker and falls back.
    request_queue_size = socket.SOMAXCONN


class _UnixServer(socketserver.ThreadingUnixStreamServer):
    daemon_threads = True
    request_queue_size = socket.SOMAXCONN


# -- stats endpoint (FleetCollector scrape surface) -------------------------


class _StatsHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *a):
        pass

    def _reply(self, code: int, body: bytes, ctype="application/json"):
        self.send_response(code)
        self.send_header("content-type", ctype)
        self.send_header("content-length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        import urllib.parse

        path = self.path
        try:
            if path == "/info":
                doc = {
                    "name": self.server.sidecar_name,
                    "role": "sidecar",
                    "sidecar": self.server.service.stats(),
                }
                self._reply(200, json.dumps(doc, sort_keys=True).encode())
            elif path == "/metrics" or path.startswith("/metrics?"):
                q = urllib.parse.parse_qs(
                    urllib.parse.urlparse(path).query
                )
                accept = self.headers.get("accept") or ""
                want_prom = q.get("format", [""])[0] == "prometheus" or (
                    "application/json" not in accept
                    and ("text/plain" in accept or "openmetrics" in accept)
                )
                if want_prom:
                    self._reply(
                        200,
                        metrics.prometheus().encode(),
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                else:
                    self._reply(
                        200,
                        json.dumps(
                            metrics.snapshot(), sort_keys=True
                        ).encode(),
                    )
            elif path == "/trace" or path.startswith("/trace?"):
                from bftkv_tpu_torch import trace as trmod

                q = urllib.parse.parse_qs(
                    urllib.parse.urlparse(path).query
                )
                try:
                    since = int(q.get("since", ["0"])[0])
                except ValueError:
                    since = 0
                doc = trmod.tracer.export(max(0, since))
                doc["slow"] = trmod.tracer.slow()
                self._reply(
                    200,
                    json.dumps(doc, sort_keys=True, default=str).encode(),
                )
            elif path == "/recalibrate":
                # Devtools hook: force a fresh host/device
                # calibration and re-apply it live.  GET for
                # curl convenience; the stats port is loopback/operator
                # surface, and the action is idempotent re-measurement.
                cal = self.server.service.recalibrate()
                self._reply(
                    200, json.dumps(cal, sort_keys=True, default=str).encode()
                )
            else:
                self._reply(404, b'"unknown endpoint"')
        except Exception as e:  # operator surface: never kill the sidecar
            self._reply(500, json.dumps(str(e)).encode())

    def do_POST(self):
        # Drain any body so keep-alive framing survives the reply.
        ln = int(self.headers.get("content-length") or 0)
        if ln:
            self.rfile.read(min(ln, 1 << 16))
        if self.path == "/recalibrate":
            return self.do_GET()
        self._reply(404, b'"unknown endpoint"')


def serve(
    listen: str,
    *,
    max_batch: int = 4096,
    max_wait: float | None = None,
    max_frame: int = 1 << 26,
    secret: bytes | None = None,
    stats: str = "",
    name: str = "sidecar01",
    admission: AdmissionQueue | None = None,
    device=None,
):
    """Start the sidecar on ``device`` (``cuda:0`` unless the caller asks
    for ``"cpu"``); returns (server, thread) for embedding.

    ``listen`` is ``host:port`` or ``unix:/path/to.sock`` (socket file
    created mode 0600 — only this uid's processes can reach the
    service).  ``stats`` optionally serves /info + /metrics + /trace
    on an HTTP port for the fleet collector (``role=sidecar``).
    """
    if listen.startswith("unix:"):
        path = listen[len("unix:"):]
        try:
            os.unlink(path)
        except OSError:
            pass
        # umask, not post-bind chmod: the socket must never be
        # world-connectable, even for the bind→chmod window (a peer
        # that connects in that window keeps its connection).
        old_umask = os.umask(0o177)
        try:
            srv = _UnixServer(path, _Handler)
        finally:
            os.umask(old_umask)
        os.chmod(path, 0o600)
    else:
        host, _, port = listen.rpartition(":")
        srv = _Server((host or "127.0.0.1", int(port)), _Handler)
    try:
        srv.service = SidecarService(
            max_batch=max_batch, max_wait=max_wait, admission=admission,
            device=device,
        )
    except BaseException:
        srv.server_close()
        raise
    #: Back-compat alias: v1 handling and existing embedders address
    #: the verify dispatcher as ``srv.dispatcher``.
    srv.dispatcher = srv.service.verify
    srv.max_frame = max_frame
    srv.secret = secret
    # Sign keys may only arrive over a channel a local squatter cannot
    # impersonate: the 0600 unix socket, or HMAC-authenticated frames.
    srv.keys_ok = listen.startswith("unix:") or secret is not None
    srv.stats_httpd = None
    if stats:
        host, _, port = stats.rpartition(":")
        httpd = ThreadingHTTPServer(
            (host or "127.0.0.1", int(port)), _StatsHandler
        )
        httpd.daemon_threads = True
        httpd.service = srv.service
        httpd.sidecar_name = name
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        srv.stats_httpd = httpd
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t


def load_secret(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read().strip()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="shared crypto sidecar")
    ap.add_argument("--listen", default="127.0.0.1:7900",
                    help="host:port, or unix:/path/to.sock (recommended: "
                         "a TCP port can be squatted after a crash, and "
                         "sign-key registration needs unix or --secret-"
                         "file)")
    ap.add_argument("--max-batch", type=int, default=4096)
    ap.add_argument("--secret-file", default="",
                    help="file holding a shared secret; frames are then "
                         "HMAC-authenticated both ways (use for TCP)")
    ap.add_argument("--stats", default="",
                    help="host:port for the /info + /metrics + /trace "
                         "stats endpoint the fleet collector scrapes "
                         "(role=sidecar member)")
    ap.add_argument("--name", default="sidecar01",
                    help="member name reported on the stats /info")
    ap.add_argument("--device", default=devmod.DEFAULT,
                    help="device of the dispatchers: cuda:N (the kernels), or "
                         "cpu (host tier and plain versions)")
    args = ap.parse_args(argv)
    secret = load_secret(args.secret_file) if args.secret_file else None
    srv, t = serve(
        args.listen,
        max_batch=args.max_batch,
        secret=secret,
        stats=args.stats,
        name=args.name,
        device=args.device,
    )
    print(
        f"crypto-sidecar: listening on {args.listen} ({srv.service.device})"
        + (f", stats @ {args.stats}" if args.stats else ""),
        flush=True,
    )
    try:
        t.join()
    except KeyboardInterrupt:
        srv.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
