"""Cross-request batching dispatchers (counterpart of ``bftkv_tpu/ops/dispatch.py``).

Callers on many threads submit item batches and block on a future; a
collector thread flushes when ``max_batch`` items are pending or
``max_wait`` has passed since the first pending item; one batched
device launch serves every caller in the flush, and results are
scattered back to the futures.  Three instances exist: the verify
dispatcher (``VerifierDomain.verify_batch``), the sign dispatcher
(``SignerDomain.sign_batch``, RSA items only so far) and the raw
modexp dispatcher (:class:`ModexpDispatcher`, RNS kernel K2).

The plane is the reference's:

- **pipelined flush workers**: up to ``pipeline`` flushes in flight (2
  on a ``cuda`` device, 1 on the ``cpu``; ``BFTKV_DISPATCH_PIPELINE``
  overrides).  Each worker on a ``cuda`` device owns one CUDA stream and
  runs its flushes under it, so flush N+1's host assembly and copies
  overlap flush N's kernel.  The GIL still lets one worker encode at a
  time: the overlap is with device and copy time, not between encoders;
- **async launch/complete** (``BFTKV_DISPATCH_ASYNC``, on): a flush
  whose dispatcher has a non-blocking :meth:`_launch_batch` hands the
  completion to one drain thread, which finalizes launches FIFO;
- **calibration**: :func:`calibration` probes the resolved torch
  device; on a CPU device the plain kernels lose to host ``pow`` at
  every batch size, so it pins the dispatchers to the host — and only
  there.  :func:`note_launch_rtt` feeds observed round trips into an
  EWMA that :func:`recalibrate` prefers over a fresh probe;
- hooks: the ``dispatch.flush`` failpoint and the ``<name>.launch`` /
  ``<name>.flush`` / ``dispatch.wait`` trace spans.

Two departures from the reference, both deliberate:

- no fallback that hides the device: an error of a kernel build, launch
  or wait reaches the flush's callers through their futures.  The
  reference's ``ModexpDispatcher`` answers such a failure from the host
  (``bftkv_tpu/ops/dispatch.py:901-902, 939-940, 950-951``); here only
  ``power_mod_rns`` returning ``None`` (moduli the RNS bases decline)
  goes to the host tier;
- stop and restart cannot strand a batch (the reference's caveat at
  ``dispatch.py:270``): each start builds a new :class:`_Pool`, and a
  hand-off to a pool that ``stop()`` has closed is flushed by the
  thread that holds it, as is a completion that reaches a closed drain.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time

import numpy as np
import torch

from bftkv_tpu_torch import device as devmod
from bftkv_tpu_torch import flags, trace
from bftkv_tpu_torch.devtools.lockwatch import named_lock
from bftkv_tpu_torch.faults import failpoint as fp
from bftkv_tpu_torch.metrics import registry as metrics

__all__ = [
    "ALWAYS_HOST",
    "ModexpDispatcher",
    "SignDispatcher",
    "VerifyDispatcher",
    "calibration",
    "get",
    "get_signer",
    "install",
    "install_signer",
    "note_launch_rtt",
    "observed_launch_rtt",
    "recalibrate",
    "uninstall",
    "uninstall_all",
    "uninstall_signer",
]

#: Sentinel crossover meaning "the device never wins for this backend".
ALWAYS_HOST = 1 << 30

_calibration_lock = named_lock("dispatch.calibration")
_CALIBRATION: dict[str, dict] = {}  # keyed by the resolved device
_LAUNCH_RTT_EWMA: float | None = None


def note_launch_rtt(seconds: float) -> None:
    """Feed one observed launch round trip into the online-recalibration
    EWMA (α = 0.2) and the ``dispatch.launch_rtt`` gauge."""
    global _LAUNCH_RTT_EWMA
    with _calibration_lock:
        prev = _LAUNCH_RTT_EWMA
        _LAUNCH_RTT_EWMA = seconds if prev is None else 0.8 * prev + 0.2 * seconds
        metrics.gauge("dispatch.launch_rtt", _LAUNCH_RTT_EWMA)


def observed_launch_rtt() -> float | None:
    with _calibration_lock:
        return _LAUNCH_RTT_EWMA


def calibration(force: bool = False, *, device=None) -> dict:
    """Host-verify cost vs device launch round trip, once per device.

    ``crossover ≈ rtt / host_per_item`` is the batch size where one
    launch starts beating the host loop.  ``BFTKV_DISPATCH_CROSSOVER``
    overrides the measurement (≤ 0 pins always-host).  On a ``cuda``
    device the round trips real flushes observed (:func:`note_launch_rtt`)
    outrank a trivial-op probe (``source="observed"``).
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
                "device_rtt_s": _LAUNCH_RTT_EWMA,
                "verify_crossover": ALWAYS_HOST if pinned else x,
                "sign_crossover": ALWAYS_HOST if pinned else None,
                "prefer_host": pinned,
                "source": "override",
            }
            metrics.gauge("dispatch.crossover", -1 if pinned else x)
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
            rtt = _LAUNCH_RTT_EWMA
            source = "observed"
            if rtt is None:
                # Round trip of a trivial op on device-resident operands:
                # a lower bound on any real launch.
                x = torch.zeros((256, 128), dtype=torch.int32, device=dev)
                (x * 2 + 1).cpu()  # first launch outside the timing
                t0 = time.perf_counter()
                for _ in range(3):
                    (x * 2 + 1).cpu()
                rtt = (time.perf_counter() - t0) / 3
                source = "probe"
            cal = {
                "backend": dev.type,
                "host_verify_s": host_s,
                "device_rtt_s": rtt,
                # Floor of 16 so a noisy fast-RTT measurement cannot push
                # tiny batches onto the device.
                "verify_crossover": max(16, int(rtt / max(host_s, 1e-7))),
                "sign_crossover": None,
                "prefer_host": False,
                "source": source,
            }
        metrics.gauge(
            "dispatch.crossover",
            -1 if cal["verify_crossover"] == ALWAYS_HOST else cal["verify_crossover"],
        )
        _CALIBRATION[str(dev)] = cal
        return cal


class _Pending:
    __slots__ = ("items", "event", "result", "error")

    def __init__(self, items):
        self.items = items
        self.event = threading.Event()
        self.result = None
        self.error: Exception | None = None


def _fail(batch: list[_Pending], e: Exception) -> None:
    for p in batch:
        p.error = e
        p.event.set()


def _stream_scope(dev: torch.device | None):
    """The scope a flush thread runs in: its own CUDA stream on a
    ``cuda`` device, nothing on the CPU."""
    if dev is None or dev.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(torch.cuda.Stream(dev))


class _Pool:
    """One generation of a dispatcher's flush workers and completion
    drain, built by ``start()`` and closed by ``stop()``.

    A hand-off (:meth:`hand_off`, :meth:`complete_later`) and the close
    that ends it take one lock, so every hand-off either lands ahead of
    the close's sentinels (and is served by the pool) or is refused (and
    the caller serves it itself): no batch is left on a queue that no
    thread reads.
    """

    def __init__(self, owner: "_BatchDispatcher", pipeline: int, use_async: bool):
        self.lock = named_lock("dispatch.pool")
        self.closed = False  # no hand-off to the workers any more
        self.drain_closed = False  # no completion to the drain any more
        self.work: queue.SimpleQueue | None = None
        self.inflight: threading.BoundedSemaphore | None = None
        self.workers: list[threading.Thread] = []
        self.completions: queue.SimpleQueue | None = None
        self.async_slots: threading.BoundedSemaphore | None = None
        self.drain: threading.Thread | None = None
        dev = owner._device()
        if pipeline > 1:
            # Persistent flush workers; the semaphore bounds batches
            # handed off but not yet flushed, so the collector stalls
            # (and submits keep coalescing) when the pipeline is full.
            self.inflight = threading.BoundedSemaphore(pipeline)
            self.work = queue.SimpleQueue()
            self.workers = [
                threading.Thread(target=owner._flush_worker, args=(self, dev), daemon=True)
                for _ in range(pipeline)
            ]
        if use_async:
            # One drain thread whatever the pipeline width: completions
            # finalize FIFO.  The semaphore bounds launches dispatched
            # but not yet finalized.
            self.completions = queue.SimpleQueue()
            self.async_slots = threading.BoundedSemaphore(pipeline + 1)
            self.drain = threading.Thread(
                target=owner._completion_drain, args=(self.completions,), daemon=True
            )

    def start(self) -> None:
        for w in self.workers:
            w.start()
        if self.drain is not None:
            self.drain.start()

    def hand_off(self, batch) -> bool:
        with self.lock:
            if self.closed:
                return False
            self.work.put(batch)
            return True

    def complete_later(self, entry) -> bool:
        with self.lock:
            if self.drain_closed:
                return False
            self.completions.put(entry)
            return True

    def close(self, timeout: float) -> None:
        """Queued batches flush first (FIFO), then each worker eats one
        sentinel; the drain closes last, behind every launch the workers
        made.  A thread wedged past ``timeout`` is abandoned as a daemon."""
        if self.workers:
            with self.lock:
                self.closed = True
                for _ in self.workers:
                    self.work.put(None)
            for w in self.workers:
                w.join(timeout=timeout)
        with self.lock:
            self.closed = self.drain_closed = True
            if self.drain is not None:
                self.completions.put(None)
        if self.drain is not None:
            self.drain.join(timeout=timeout)


class _BatchDispatcher:
    """Accumulates per-thread requests into shared device batches."""

    #: metrics prefix; subclasses override.
    name = "dispatch"

    #: Flushes in flight on a ``cuda`` device (``BFTKV_DISPATCH_PIPELINE``
    #: overrides).  On the CPU the "device" is the host: a second flush
    #: worker contends with the kernel for cores, so the default there is 1.
    DEFAULT_PIPELINE_CUDA = 2

    #: Seconds ``stop()`` waits for each thread before abandoning it.
    STOP_TIMEOUT = 5.0

    def __init__(
        self,
        *,
        max_batch: int = 1024,
        max_wait: float = 0.002,
        pipeline: int | None = None,
        calibrate: bool | None = None,
    ):
        self.max_batch = max_batch
        self.max_wait = max_wait
        if calibrate is None:
            calibrate = flags.raw("BFTKV_DISPATCH_CALIBRATE", "1") != "0"
        self._calibrate = calibrate
        #: True once calibration decides the host beats a launch at any
        #: batch this device can see: callers then run host inline.
        self._prefer_host = False
        if pipeline is None:
            pipeline = flags.get_int("BFTKV_DISPATCH_PIPELINE")
        self.pipeline = max(1, pipeline) if pipeline is not None else None
        self._async = flags.enabled("BFTKV_DISPATCH_ASYNC")
        self._pool: _Pool | None = None
        self._lock = named_lock("dispatch.batcher")
        self._cv = threading.Condition(self._lock)
        self._queue: list[_Pending] = []
        self._queued_items = 0
        self._running = False
        self._thread: threading.Thread | None = None

    # -- subclass hooks ---------------------------------------------------

    def _device(self) -> torch.device | None:
        """The device the flushes launch on (``None``: no device)."""
        return None

    def _run_batch(self, items: list):
        """One batched launch; returns a sequence aligned with items."""
        raise NotImplementedError

    def _launch_batch(self, items: list):
        """Non-blocking launch for the async path: stage ``items``, put the
        launch on the current stream without waiting for it, and return a
        zero-argument completion that waits and returns a sequence
        aligned with ``items``.  ``None`` declines: the flush then takes
        :meth:`_run_batch` (the default)."""
        return None

    def prefer_host(self, n_items: int) -> bool:
        return self._prefer_host

    def _combine(self, chunks: list):
        return np.concatenate(chunks)

    def _empty(self):
        return np.zeros((0,), dtype=bool)

    # -- lifecycle --------------------------------------------------------

    def start(self):
        if self.pipeline is None:
            dev = self._device()
            self.pipeline = (
                self.DEFAULT_PIPELINE_CUDA if dev is not None and dev.type == "cuda" else 1
            )
        with self._lock:
            if self._running:
                return self
            self._running = True
        pool = self._pool = _Pool(self, self.pipeline, self._async)
        pool.start()
        self._thread = threading.Thread(target=self._collector, args=(pool,), daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._cv:
            self._running = False
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=self.STOP_TIMEOUT)
            self._thread = None
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.close(self.STOP_TIMEOUT)

    def _flush_worker(self, pool: _Pool, dev) -> None:
        # The pool rides in as an argument: a worker abandoned by a
        # timed-out stop() keeps releasing its own pool's permits.
        with _stream_scope(dev):
            while True:
                batch = pool.work.get()
                if batch is None:
                    return
                try:
                    self._flush(batch, pool)
                finally:
                    pool.inflight.release()

    # -- caller side ------------------------------------------------------

    def submit(self, items: list):
        """Blocking batched call; safe from any thread."""
        if not items:
            return self._empty()
        p = _Pending(items)
        t0 = time.perf_counter()
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
        if trace.capture() is not None:
            # Inside a request trace, the queue wait is its "dispatch" phase.
            with trace.span("dispatch.wait", attrs={"items": len(items), "pool": self.name}):
                p.event.wait()
        else:
            p.event.wait()
        metrics.observe(f"{self.name}.wait", time.perf_counter() - t0)
        if p.error is not None:
            raise p.error
        return p.result

    # -- collector --------------------------------------------------------

    def _collector(self, pool: _Pool) -> None:
        with _stream_scope(self._device()):
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
                    # Whole pending entries up to max_batch items (always
                    # at least one); the rest flushes on the next loop.
                    batch = []
                    taken = 0
                    while self._queue and (
                        not batch or taken + len(self._queue[0].items) <= self.max_batch
                    ):
                        p = self._queue.pop(0)
                        batch.append(p)
                        taken += len(p.items)
                    self._queued_items -= taken
                if pool.work is None:
                    self._flush(batch, pool)
                    continue
                # Bounded hand-off: at most ``pipeline`` batches past here.
                pool.inflight.acquire()
                if not pool.hand_off(batch):
                    # stop() closed this pool (it may already run another):
                    # serve these callers here.
                    try:
                        self._flush(batch, pool)
                    finally:
                        pool.inflight.release()

    def _flush(self, batch: list[_Pending], pool: _Pool) -> None:
        if fp.ARMED:
            # ``dispatch.flush`` failpoint: a stalled device launch.
            act = fp.fire("dispatch.flush", name=self.name)
            if act is not None and act.kind == "stall":
                time.sleep(fp.delay_seconds(act))
        flat = [it for p in batch for it in p.items]
        occupancy = len(flat) / self.max_batch
        metrics.observe(f"{self.name}.batch", len(flat))
        metrics.gauge(f"{self.name}.occupancy", occupancy)
        metrics.incr(f"{self.name}.flushes")
        metrics.incr(f"{self.name}.items", len(flat))
        launches = max(1, -(-len(flat) // self.max_batch))
        metrics.incr(f"{self.name}.launches", launches)
        metrics.gauge(
            f"{self.name}.device_occupancy",
            len(flat) / (launches * self.max_batch),
            labels={"width": "all"},
        )
        t0 = time.perf_counter()
        if self._async and pool.completions is not None and len(flat) <= self.max_batch:
            slots = pool.async_slots
            slots.acquire()
            try:
                with trace.span(
                    f"{self.name}.launch", attrs={"batch_size": len(flat)}, phase="dispatch"
                ):
                    completion = self._launch_batch(flat)
            except Exception as e:
                slots.release()
                _fail(batch, e)
                return
            if completion is not None:
                entry = (batch, len(flat), completion, t0, slots)
                if not pool.complete_later(entry):
                    self._finalize(entry)  # the drain is closed: finalize here
                return
            slots.release()
        with trace.span(
            f"{self.name}.flush",
            attrs={"batch_size": len(flat), "occupancy": round(occupancy, 4)},
            phase="dispatch",
        ) as sp:
            try:
                if len(flat) <= self.max_batch:
                    out = self._run_batch(flat)
                else:
                    # An oversized entry: chunk the launches so padded
                    # batch shapes stay bounded by max_batch.
                    out = self._combine([
                        self._run_batch(flat[i : i + self.max_batch])
                        for i in range(0, len(flat), self.max_batch)
                    ])
            except Exception as e:
                # Never raise here (it would kill the collector or the
                # worker): the error reaches every caller of this flush.
                sp.attrs["error"] = repr(e)
                _fail(batch, e)
                return
            dt = time.perf_counter() - t0
            metrics.observe(f"{self.name}.flush.seconds", dt)
            if dt > 0:
                sp.attrs["items_per_s"] = round(len(flat) / dt, 1)
                metrics.gauge(f"{self.name}.throughput", len(flat) / dt)
        _scatter(batch, out)

    def _completion_drain(self, completions: queue.SimpleQueue) -> None:
        # Finalizes async launches strictly FIFO; like the flush workers
        # it must never die to an item error.
        while True:
            entry = completions.get()
            if entry is None:
                return
            self._finalize(entry)

    def _finalize(self, entry) -> None:
        batch, n_items, completion, t0, slots = entry
        try:
            out = completion()
        except Exception as e:
            _fail(batch, e)
            return
        finally:
            slots.release()
        dt = time.perf_counter() - t0
        metrics.observe(f"{self.name}.flush.seconds", dt)
        if dt > 0:
            metrics.gauge(f"{self.name}.throughput", n_items / dt)
        note_launch_rtt(dt)
        _scatter(batch, out)


def _scatter(batch: list[_Pending], out) -> None:
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
        pipeline: int | None = None,
        calibrate: bool | None = None,
        device=None,
    ):
        super().__init__(
            max_batch=max_batch, max_wait=max_wait, pipeline=pipeline, calibrate=calibrate
        )
        if verifier is None:
            from bftkv_tpu_torch.crypto import rsa as rsamod

            verifier = rsamod.VerifierDomain(device=device)
        self.verifier = verifier

    def _device(self):
        return getattr(self.verifier, "device", None)

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
        pipeline: int | None = None,
        calibrate: bool | None = None,
        device=None,
    ):
        super().__init__(
            max_batch=max_batch,
            max_wait=self.DEFAULT_MAX_WAIT if max_wait is None else max_wait,
            pipeline=pipeline,
            calibrate=calibrate,
        )
        if signer is None:
            from bftkv_tpu_torch.crypto import rsa as rsamod

            signer = rsamod.SignerDomain(device=device)
        self.signer = signer
        self._signer_default_threshold = getattr(signer, "host_threshold", None)

    def _device(self):
        return getattr(self.signer, "device", None)

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


class ModexpDispatcher(_BatchDispatcher):
    """Batched raw modular exponentiation (items: (base, exp, mod) ints).

    Batches at or above ``device_threshold`` run one RNS launch (kernel
    K2) per limb-width group of their device-eligible items (odd moduli
    above 2, non-negative bases and exponents); the rest, and groups
    whose moduli the RNS bases decline, take host ``pow`` (the reference
    uses its native Montgomery modexp there, not yet ported).  On the
    async path every group's launch goes on the stream before any is
    waited on.
    """

    name = "modexpdispatch"

    def __init__(
        self,
        *,
        max_batch: int = 1024,
        max_wait: float = 0.002,
        pipeline: int | None = None,
        calibrate: bool | None = None,
        device_threshold: int | None = None,
        device=None,
    ):
        super().__init__(
            max_batch=max_batch, max_wait=max_wait, pipeline=pipeline, calibrate=calibrate
        )
        self.device = devmod.resolve(device)
        # Below it, one host modexp per item beats any launch.
        self.device_threshold = (
            device_threshold if device_threshold is not None else ALWAYS_HOST
        )

    def _device(self):
        return self.device

    def apply_calibration(self, cal: dict) -> None:
        self._prefer_host = cal["prefer_host"]
        self.device_threshold = ALWAYS_HOST if cal["prefer_host"] else cal["verify_crossover"]

    @staticmethod
    def _eligible(b: int, e: int, m: int) -> bool:
        return m > 2 and m % 2 == 1 and e >= 0 and b >= 0

    def _width_groups(self, items: list, device_idx: list[int]) -> dict[int, list[int]]:
        from bftkv_tpu_torch.ops import limb

        # One launch per limb-width group (uniform kernel shapes).
        by_width: dict[int, list[int]] = {}
        for i in device_idx:
            w = limb.nlimbs_for_bits(items[i][2].bit_length())
            by_width.setdefault(w, []).append(i)
        return by_width

    def _note_device_group(self, w: int, idxs: list[int]) -> None:
        metrics.incr("modexp.device", len(idxs))
        metrics.gauge(
            "modexpdispatch.device_occupancy",
            min(1.0, len(idxs) / self.max_batch),
            labels={"width": str(w)},
        )

    def _group_launch(self, items: list, w: int, idxs: list[int], defer: bool):
        from bftkv_tpu_torch.ops import rns

        return rns.power_mod_rns(
            [items[i][0] for i in idxs],
            [items[i][1] for i in idxs],
            [items[i][2] for i in idxs],
            n_bits=w * 16, defer=defer, device=self.device,
        )

    def _run_batch(self, items: list) -> list[int]:
        out: list[int | None] = [None] * len(items)
        device_idx: list[int] = []
        if len(items) >= self.device_threshold:
            device_idx = [i for i, it in enumerate(items) if self._eligible(*it)]
        for w, idxs in self._width_groups(items, device_idx).items():
            vals = self._group_launch(items, w, idxs, defer=False)
            if vals is not None:  # None: moduli the RNS bases decline
                self._note_device_group(w, idxs)
                for i, v in zip(idxs, vals):
                    out[i] = int(v)
        self._host_fill(items, out)
        return out  # type: ignore[return-value]

    def _launch_batch(self, items: list):
        """Every width group's K2 launch on the stream before any wait.
        Declines (``None``: the synchronous path) below the device
        threshold or when the batch mixes in device-ineligible items."""
        if len(items) < self.device_threshold:
            return None
        if not all(self._eligible(*it) for it in items):
            return None
        launches: list[tuple[int, list[int], object]] = []
        try:
            for w, idxs in self._width_groups(items, list(range(len(items)))).items():
                launches.append((w, idxs, self._group_launch(items, w, idxs, defer=True)))
        except BaseException:
            for _w, _idxs, d in launches:
                if d is not None:
                    with contextlib.suppress(Exception):
                        d.wait()  # releases its staging slot
            raise

        def complete() -> list[int]:
            out: list[int | None] = [None] * len(items)
            err = None
            for w, idxs, d in launches:
                if d is None:
                    continue  # moduli the RNS bases decline: host below
                try:
                    vals = d.wait()
                except Exception as e:  # every group's slot is released first
                    err = err or e
                    continue
                self._note_device_group(w, idxs)
                for i, v in zip(idxs, vals):
                    out[i] = int(v)
            if err is not None:
                raise err
            self._host_fill(items, out)
            return out  # type: ignore[return-value]

        return complete

    def _host_fill(self, items: list, out: list) -> None:
        """Host tier for every item the device did not answer."""
        host = 0
        for i, (b, e, m) in enumerate(items):
            if out[i] is not None:
                continue
            host += 1
            if m <= 0:
                raise ValueError("modexp: modulus must be positive")
            out[i] = pow(b, e, m)
        if host:
            metrics.incr("modexp.host", host)

    def _combine(self, chunks: list):
        return [v for chunk in chunks for v in chunk]

    def _empty(self):
        return []

    def powmod(self, base: int, exp: int, mod: int) -> int:
        return self.submit([(base, exp, mod)])[0]


_global: VerifyDispatcher | None = None
_global_signer: SignDispatcher | None = None
_global_lock = named_lock("dispatch.install")


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


def recalibrate(device=None) -> dict:
    """Force a fresh calibration of each installed dispatcher's device and
    re-apply it; returns the calibration of ``device`` (default: the
    installed verify dispatcher's, else the signer's, else ``cuda:0``)."""
    fresh: dict[str, dict] = {}
    with _global_lock:
        installed = [d for d in (_global, _global_signer) if d is not None]
        for d in installed:
            dev = devmod.resolve(d._device())
            if str(dev) not in fresh:
                fresh[str(dev)] = calibration(force=True, device=dev)
            if d._calibrate:
                d.apply_calibration(fresh[str(dev)])
    if device is None and installed:
        device = installed[0]._device()
    dev = devmod.resolve(device)
    return fresh.get(str(dev)) or calibration(force=True, device=dev)


def uninstall_all() -> None:
    uninstall()
    uninstall_signer()
