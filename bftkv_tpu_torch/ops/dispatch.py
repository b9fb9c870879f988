"""Cross-request batching dispatchers (counterpart of ``bftkv_tpu/ops/dispatch.py``).

Callers on many threads submit item batches and block on a future; a
collector thread flushes when ``max_batch`` items are pending or
``max_wait`` has passed since the first pending item; one batched
device launch serves every caller in the flush, and results are
scattered back to the futures.  Two instances exist: the verify
dispatcher (``VerifierDomain.verify_batch``) and the sign dispatcher
(``SignerDomain.sign_batch``, RSA items only in this slice).

Flushes here are synchronous, one at a time (the reference's
``pipeline=1``); the async launch path, pipelined flush workers and the
staging rings arrive with a later slice.  :func:`calibration` probes
the resolved torch device: on a CPU device the plain kernels lose to
host ``pow`` at every batch size, so it pins the dispatchers to the
host — and only there.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from bftkv_tpu_torch import device as devmod
from bftkv_tpu_torch import flags
from bftkv_tpu_torch.metrics import registry as metrics

__all__ = [
    "ALWAYS_HOST",
    "SignDispatcher",
    "VerifyDispatcher",
    "calibration",
    "get",
    "get_signer",
    "install",
    "install_signer",
    "uninstall",
    "uninstall_signer",
]

#: Sentinel crossover meaning "the device never wins for this backend".
ALWAYS_HOST = 1 << 30

_calibration_lock = threading.Lock()
_CALIBRATION: dict[str, dict] = {}  # keyed by the resolved device


def calibration(force: bool = False, *, device=None) -> dict:
    """Host-verify cost vs device launch round trip, once per device.

    ``crossover ≈ rtt / host_per_item`` is the batch size where one
    launch starts beating the host loop.  ``BFTKV_DISPATCH_CROSSOVER``
    overrides the measurement (≤ 0 pins always-host).
    """
    dev = devmod.resolve(device)
    with _calibration_lock:
        cached = _CALIBRATION.get(str(dev))
        if cached is not None and not force:
            return cached
        env = flags.raw("BFTKV_DISPATCH_CROSSOVER")
        if env is not None:
            x = int(env)
            pinned = x <= 0
            cal = {
                "backend": dev.type,
                "host_verify_s": None,
                "device_rtt_s": None,
                "verify_crossover": ALWAYS_HOST if pinned else x,
                "sign_crossover": ALWAYS_HOST if pinned else None,
                "prefer_host": pinned,
                "source": "override",
            }
            _CALIBRATION[str(dev)] = cal
            return cal
        # Host per-item cost: raw pow on a fixed odd 2048-bit modulus.
        n = (1 << 2047) + 973
        s = (1 << 2040) // 7
        t0 = time.perf_counter()
        reps = 12
        for _ in range(reps):
            pow(s, 65537, n)
        host_s = (time.perf_counter() - t0) / reps
        if dev.type == "cpu":
            cal = {
                "backend": "cpu",
                "host_verify_s": host_s,
                "device_rtt_s": None,
                "verify_crossover": ALWAYS_HOST,
                "sign_crossover": ALWAYS_HOST,
                "prefer_host": True,
                "source": "probe",
            }
        else:
            # Round trip of a trivial op on device-resident operands: a
            # lower bound on any real launch.
            x = torch.zeros((256, 128), dtype=torch.int32, device=dev)
            (x * 2 + 1).cpu()  # first launch outside the timing
            t0 = time.perf_counter()
            for _ in range(3):
                (x * 2 + 1).cpu()
            rtt = (time.perf_counter() - t0) / 3
            cal = {
                "backend": dev.type,
                "host_verify_s": host_s,
                "device_rtt_s": rtt,
                # Floor of 16 so a noisy fast-RTT measurement cannot push
                # tiny batches onto the device.
                "verify_crossover": max(16, int(rtt / max(host_s, 1e-7))),
                "sign_crossover": None,
                "prefer_host": False,
                "source": "probe",
            }
        _CALIBRATION[str(dev)] = cal
        return cal


class _Pending:
    __slots__ = ("items", "event", "result", "error")

    def __init__(self, items):
        self.items = items
        self.event = threading.Event()
        self.result = None
        self.error: Exception | None = None


class _BatchDispatcher:
    """Accumulates per-thread requests into shared device batches."""

    #: metrics prefix; subclasses override.
    name = "dispatch"

    def __init__(
        self,
        *,
        max_batch: int = 1024,
        max_wait: float = 0.002,
        calibrate: bool = True,
    ):
        self.max_batch = max_batch
        self.max_wait = max_wait
        self._calibrate = calibrate
        #: True once calibration decides the host beats a launch at any
        #: batch this device can see: callers then run host inline.
        self._prefer_host = False
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: list[_Pending] = []
        self._queued_items = 0
        self._running = False
        self._thread: threading.Thread | None = None

    # -- subclass hooks ---------------------------------------------------

    def _run_batch(self, items: list):
        """One batched launch; returns a sequence aligned with items."""
        raise NotImplementedError

    def prefer_host(self, n_items: int) -> bool:
        return self._prefer_host

    def _combine(self, chunks: list):
        return np.concatenate(chunks)

    def _empty(self):
        return np.zeros((0,), dtype=bool)

    # -- lifecycle --------------------------------------------------------

    def start(self):
        with self._lock:
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(target=self._collector, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._cv:
            self._running = False
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    # -- caller side ------------------------------------------------------

    def submit(self, items: list):
        """Blocking batched call; safe from any thread."""
        if not items:
            return self._empty()
        p = _Pending(items)
        with self._cv:
            # Checked under the lock: a racing stop() must not strand
            # this entry behind an exited collector.
            running = self._running
            if running:
                self._queue.append(p)
                self._queued_items += len(items)
                self._cv.notify_all()
        if not running:
            return self._run_batch(items)
        p.event.wait()
        if p.error is not None:
            raise p.error
        return p.result

    # -- collector --------------------------------------------------------

    def _collector(self) -> None:
        while True:
            with self._cv:
                while self._running and not self._queue:
                    self._cv.wait()
                if not self._running and not self._queue:
                    return
                deadline = time.monotonic() + self.max_wait
                while (
                    self._running
                    and self._queued_items < self.max_batch
                    and (remaining := deadline - time.monotonic()) > 0
                ):
                    self._cv.wait(timeout=remaining)
                # Whole pending entries up to max_batch items (always at
                # least one); the rest flushes on the next iteration.
                batch = []
                taken = 0
                while self._queue and (
                    not batch
                    or taken + len(self._queue[0].items) <= self.max_batch
                ):
                    p = self._queue.pop(0)
                    batch.append(p)
                    taken += len(p.items)
                self._queued_items -= taken
            self._flush(batch)

    def _flush(self, batch: list[_Pending]) -> None:
        flat = [it for p in batch for it in p.items]
        metrics.incr(f"{self.name}.flushes")
        metrics.incr(f"{self.name}.items", len(flat))
        try:
            if len(flat) <= self.max_batch:
                out = self._run_batch(flat)
            else:
                # An oversized entry: chunk the launches so padded batch
                # shapes stay bounded by max_batch.
                out = self._combine(
                    [
                        self._run_batch(flat[i : i + self.max_batch])
                        for i in range(0, len(flat), self.max_batch)
                    ]
                )
        except Exception as e:
            # Never raise here (it would kill the collector): the error
            # reaches every caller of this flush through its future.
            for p in batch:
                p.error = e
                p.event.set()
            return
        off = 0
        for p in batch:
            p.result = out[off : off + len(p.items)]
            off += len(p.items)
            p.event.set()


class VerifyDispatcher(_BatchDispatcher):
    """Batched signature verification (items: (message, sig, PublicKey))."""

    name = "dispatch"  # the reference's metric names

    def __init__(
        self,
        verifier=None,
        *,
        max_batch: int = 1024,
        max_wait: float = 0.002,
        calibrate: bool = True,
        device=None,
    ):
        super().__init__(max_batch=max_batch, max_wait=max_wait, calibrate=calibrate)
        if verifier is None:
            from bftkv_tpu_torch.crypto import rsa as rsamod

            verifier = rsamod.VerifierDomain(device=device)
        self.verifier = verifier

    def start(self):
        super().start()
        if self._calibrate:
            self.apply_calibration(calibration(device=self.verifier.device))
        return self

    def apply_calibration(self, cal: dict) -> None:
        # An explicit env threshold is the operator's word.
        if flags.raw("BFTKV_HOST_VERIFY_THRESHOLD") is None:
            self.verifier.host_threshold = cal["verify_crossover"]
        self._prefer_host = cal["prefer_host"]

    def _run_batch(self, items: list):
        return self.verifier.verify_batch(items)

    def verify(self, items: list) -> np.ndarray:
        if self._prefer_host:
            out = self.verifier.verify_batch(items)
        else:
            out = self.submit(items)
        metrics.incr("dispatch.verifies", len(items))
        return out


class SignDispatcher(_BatchDispatcher):
    """Batched RSA signing (items: (message, PrivateKey))."""

    name = "signdispatch"

    #: A sign launch costs far more than a verify launch, so waiting a
    #: little longer to fill it is cheap.
    DEFAULT_MAX_WAIT = 0.02

    def __init__(
        self,
        signer=None,
        *,
        max_batch: int = 1024,
        max_wait: float | None = None,
        calibrate: bool = True,
        device=None,
    ):
        super().__init__(
            max_batch=max_batch,
            max_wait=self.DEFAULT_MAX_WAIT if max_wait is None else max_wait,
            calibrate=calibrate,
        )
        if signer is None:
            from bftkv_tpu_torch.crypto import rsa as rsamod

            signer = rsamod.SignerDomain(device=device)
        self.signer = signer
        self._signer_default_threshold = getattr(signer, "host_threshold", None)

    def start(self):
        super().start()
        if self._calibrate:
            self.apply_calibration(calibration(device=self.signer.device))
        return self

    def apply_calibration(self, cal: dict) -> None:
        self._prefer_host = cal["prefer_host"]
        if flags.raw("BFTKV_HOST_SIGN_THRESHOLD") is not None:
            return
        if cal["sign_crossover"] is not None:
            self.signer.host_threshold = cal["sign_crossover"]
        elif self._signer_default_threshold is not None:
            self.signer.host_threshold = self._signer_default_threshold

    def _run_batch(self, items: list):
        return self.signer.sign_batch(items)

    def _combine(self, chunks: list):
        return [sig for chunk in chunks for sig in chunk]

    def _empty(self):
        return []

    def sign(self, message: bytes, key) -> bytes:
        return self.submit([(message, key)])[0]


_global: VerifyDispatcher | None = None
_global_signer: SignDispatcher | None = None
_global_lock = threading.Lock()


def install(dispatcher: VerifyDispatcher | None = None) -> VerifyDispatcher:
    """Install (and start) the process-wide verify dispatcher."""
    global _global
    with _global_lock:
        if _global is not None:
            _global.stop()
        _global = (dispatcher or VerifyDispatcher()).start()
        return _global


def uninstall() -> None:
    global _global
    with _global_lock:
        if _global is not None:
            _global.stop()
            _global = None


def get() -> VerifyDispatcher | None:
    return _global


def install_signer(dispatcher: SignDispatcher | None = None) -> SignDispatcher:
    """Install (and start) the process-wide sign dispatcher."""
    global _global_signer
    with _global_lock:
        if _global_signer is not None:
            _global_signer.stop()
        _global_signer = (dispatcher or SignDispatcher()).start()
        return _global_signer


def uninstall_signer() -> None:
    global _global_signer
    with _global_lock:
        if _global_signer is not None:
            _global_signer.stop()
            _global_signer = None


def get_signer() -> SignDispatcher | None:
    return _global_signer
