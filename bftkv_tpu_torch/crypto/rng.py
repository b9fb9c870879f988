"""RNG capability: a copy of ``bftkv_tpu/crypto/rng.py`` (imports rewritten
to the port's ``flags`` and ``devtools/lockwatch.py``).

``os.urandom`` releases the GIL around the ``getrandom(2)`` syscall on
EVERY call; under a loaded multi-writer process each release is a trip
to the back of the GIL queue, and the write path draws ~30 nonces/keys
per write (session envelopes alone need a content key, a GCM nonce and
one key-wrap nonce per recipient).  Profiling the cluster_4 bench
showed more wall time re-acquiring the GIL after ``urandom`` than in
all RSA math combined.

So :func:`generate_random` is backed by a per-thread hash-DRBG
(SHA-256 counter mode, the SP 800-90A Hash_DRBG shape): seeded from
``os.urandom(32)``, ratcheting its key after every read (forward
secrecy between outputs), reseeding from the OS after 1 MiB of output
or on fork (PID change).  Small ``hashlib`` calls never release the
GIL, so the hot path stays syscall-free.  ``BFTKV_OS_RNG=1`` restores
raw ``os.urandom`` for every call.
"""

from __future__ import annotations

import hashlib
import os
import threading
from bftkv_tpu_torch import flags
from bftkv_tpu_torch.devtools.lockwatch import named_lock

__all__ = ["generate_random"]

_OS_RNG = flags.raw("BFTKV_OS_RNG", "") == "1"
_RESEED_BYTES = 1 << 20

_local = threading.local()

# Thread DRBGs seed from a process-level master (itself seeded from the
# OS) instead of each calling ``os.urandom``: a fan-out burst spawning
# dozens of pool workers would otherwise pay one GIL-dropping syscall
# per thread right at the burst's latency-critical start.
_master_lock = named_lock("crypto.rng")
_master_key: bytes | None = None
_master_counter = 0
_master_pid = 0


def _master_seed() -> bytes:
    global _master_key, _master_counter, _master_pid
    with _master_lock:
        pid = os.getpid()
        if _master_key is None or _master_counter >= 4096 or _master_pid != pid:
            _master_key = os.urandom(32)
            _master_counter = 0
            _master_pid = pid
        _master_counter += 1
        seed = hashlib.sha256(
            b"seed\x00" + _master_key + _master_counter.to_bytes(8, "big")
        ).digest()
        # Ratchet the master too: a later memory compromise must not
        # reveal seeds already handed out.
        _master_key = hashlib.sha256(b"mrtc\x00" + _master_key).digest()
        return seed


class _DRBG:
    __slots__ = ("key", "counter", "generated", "pid")

    def __init__(self):
        self._reseed()

    def _reseed(self) -> None:
        self.key = _master_seed()
        self.counter = 0
        self.generated = 0
        self.pid = os.getpid()

    def read(self, n: int) -> bytes:
        if self.generated + n > _RESEED_BYTES or self.pid != os.getpid():
            self._reseed()
        out = bytearray()
        key = self.key
        while len(out) < n:
            self.counter += 1
            out += hashlib.sha256(
                b"out\x00" + key + self.counter.to_bytes(8, "big")
            ).digest()
        # Ratchet: past outputs stay unrecoverable from a later state.
        self.key = hashlib.sha256(
            b"rtc\x00" + key + self.counter.to_bytes(8, "big")
        ).digest()
        self.generated += n
        return bytes(out[:n])


def generate_random(n: int) -> bytes:
    if _OS_RNG:
        return os.urandom(n)
    d = getattr(_local, "drbg", None)
    if d is None:
        d = _local.drbg = _DRBG()
    return d.read(n)
