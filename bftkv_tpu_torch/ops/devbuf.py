"""Persistent staging rings for device launches (counterpart of
``bftkv_tpu/ops/devbuf.py``).

Every launch of the RNS entry points (``rns.power_mod_rns``,
``rns.verify_e65537_rns_indexed``) and of the ``pallas`` verify
(``crypto/rsa.py``) writes its operands into a slot of preallocated
tensors instead of allocating per flush: one :class:`BufferRing` per
(width class, padded shape, device) holds a few slots.  Live rows land
in ``[:t]``; the pad region is a broadcast copy of row 0, as the
reference pads, so the kernels see the same operands either way.

A slot holds, per operand, a host tensor (pinned on a ``cuda`` device,
so its copy to the card can be asynchronous) and the device tensor the
kernel reads; on the ``cpu`` the two are one tensor.  The reference's
buffer donation (``bftkv_tpu/ops/rns.py:490-514``) becomes reuse of
those preallocated device tensors.  On the card a flush works on its
worker's stream: fill the pinned slot, ``copy_(…, non_blocking=True)``
into the device tensors, launch, copy the result back into the pinned
output, :meth:`Slot.record` an event.

Ownership protocol, kept from the reference: a slot is the acquirer's
from :meth:`BufferRing.acquire` until :meth:`BufferRing.release`; the
in-flight bit flips under the ring lock, and ``seq`` counts
acquisitions, so a second or stale release raises instead of freeing a
slot that a later flush owns.  On the card a slot goes back to its ring
only once the event recorded behind its last use (the copy in, the
kernel or the copy out) has completed: the next owner's host writes
and copies can then never race the previous launch.  When every slot
is in flight, ``acquire`` returns ``None`` (counted as
``devbuf.overflow``) and the caller takes a :meth:`BufferRing.fresh`
slot for that launch: the ring bounds memory, never liveness.

A launch holds its slot through a :class:`Lease` (:func:`lease`):
``with lease.launch() as slot:`` fills the slot and puts the copies and
the kernel on the stream, and :meth:`Lease.collect` waits for the event,
copies the result out and returns the slot.

``devbuf.saturation{width=…}`` and ``devbuf.in_flight{width=…}`` are
the rings' gauges, as in the reference.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

from bftkv_tpu_torch import flags
from bftkv_tpu_torch.devtools.lockwatch import named_lock
from bftkv_tpu_torch.metrics import registry as metrics

__all__ = ["BufferRing", "Lease", "Slot", "enabled", "lease", "ring_for", "reset", "stats"]

_lock = named_lock("ops.devbuf")
_RINGS: dict[str, "BufferRing"] = {}


def enabled() -> bool:
    return flags.enabled("BFTKV_DISPATCH_DEVBUF")


class Slot:
    """One set of staging tensors: ``spec`` maps a name to (shape, dtype),
    or to (shape, dtype, fill) for a host tensor that starts at ``fill``
    (the EC slots' ``pad_lo`` watermark).

    ``slot[name]`` is the numpy view of the host tensor, which the fill
    code writes in place.  Exclusively the acquirer's from ``acquire()``
    until ``release()``; ``seq`` increments per acquisition.
    """

    __slots__ = ("host", "dev", "arrays", "event", "in_flight", "seq", "_cuda")

    def __init__(self, spec: dict, device: torch.device):
        self._cuda = device.type == "cuda"
        self.host = {}
        for name, (shape, dtype, *fill) in spec.items():
            t = torch.empty(shape, dtype=dtype, pin_memory=self._cuda)
            if fill:
                t.fill_(fill[0])
            self.host[name] = t
        self.dev = (
            {name: torch.empty(shape, dtype=dtype, device=device)
             for name, (shape, dtype, *_fill) in spec.items()}
            if self._cuda else self.host
        )
        self.arrays = {name: t.numpy() for name, t in self.host.items()}
        self.event = torch.cuda.Event(enable_timing=True) if self._cuda else None
        self.in_flight = False
        self.seq = 0

    def __getitem__(self, name: str):
        return self.arrays[name]

    def upload(self, names) -> dict:
        """Copies the host tensors ``names`` into the device tensors on the
        current stream, without waiting; returns the device tensors."""
        if self._cuda:
            for name in names:
                self.dev[name].copy_(self.host[name], non_blocking=True)
        return self.dev

    def download(self, name: str, src: torch.Tensor) -> None:
        """Copies a launch's result into the host tensor ``name`` on the
        current stream, without waiting on the card."""
        self.host[name].copy_(src, non_blocking=self._cuda)

    def record(self) -> None:
        """Records the slot's event behind all the work on the current
        stream: its last use so far."""
        if self.event is not None:
            self.event.record()

    def wait(self) -> None:
        """Blocks until the recorded event has completed (host side)."""
        if self.event is not None:
            self.event.synchronize()


class BufferRing:
    """A fixed ring of staging slots for one width class and shape.

    All slots are allocated up front, so a launch never pays the
    allocator; ``width`` is the bounded label of the ring's gauges (a
    digit count such as ``"64"``, ``"verify"``, ``"mont"``).
    """

    def __init__(self, key: str, spec: dict, device: torch.device, *,
                 slots: int | None = None, width: str = "all"):
        if slots is None:
            slots = flags.get_int("BFTKV_DISPATCH_DEVBUF_RING") or 4
        self.key = key
        self.width = width
        self._spec = spec
        self._device = device
        self._cv = threading.Condition(_lock)
        self._slots = [Slot(spec, device) for _ in range(max(1, slots))]
        self.overflows = 0
        self.acquires = 0

    def _gauge(self) -> None:
        busy = sum(1 for s in self._slots if s.in_flight)
        metrics.gauge("devbuf.in_flight", busy, labels={"width": self.width})
        metrics.gauge("devbuf.saturation", busy / len(self._slots),
                      labels={"width": self.width})

    def acquire(self, timeout: float = 0.0) -> Slot | None:
        """A free slot, or ``None`` when the whole ring is in flight after
        waiting up to ``timeout`` seconds."""
        with self._cv:
            deadline = None
            while True:
                for s in self._slots:
                    if not s.in_flight:
                        s.in_flight = True
                        s.seq += 1
                        self.acquires += 1
                        self._gauge()
                        return s
                if timeout <= 0:
                    break
                if deadline is None:
                    deadline = time.monotonic() + timeout
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cv.wait(timeout=remaining):
                    break
            self.overflows += 1
            metrics.incr("devbuf.overflow", labels={"width": self.width})
            self._gauge()
            return None

    def fresh(self) -> Slot:
        """An unpooled slot for the overflow path, owned by one launch."""
        return _owned(Slot(self._spec, self._device))

    def release(self, slot: Slot, seq: int | None = None) -> None:
        """Returns ``slot`` to the ring once its event has completed.

        ``seq`` is the value the owner read at acquisition; a release
        with another (the slot was re-acquired since) or of a slot not
        in flight raises ``RuntimeError``.  A fresh slot is not the
        ring's: releasing it only waits for its event.
        """
        slot.wait()
        if not any(s is slot for s in self._slots):
            return
        with self._cv:
            if not slot.in_flight:
                raise RuntimeError(f"devbuf {self.key}: release of a slot not in flight")
            if seq is not None and seq != slot.seq:
                raise RuntimeError(
                    f"devbuf {self.key}: stale release (seq {seq}, slot at {slot.seq})"
                )
            slot.in_flight = False
            self._gauge()
            self._cv.notify()


def _owned(slot: Slot) -> Slot:
    slot.in_flight, slot.seq = True, 1
    return slot


class Lease:
    """One launch's hold on a slot, from :func:`lease` until the slot is
    released — by :meth:`collect`, or by an error inside :meth:`launch`.
    ``ring`` is ``None`` for a slot that belongs to no ring."""

    __slots__ = ("ring", "slot", "seq", "_released")

    def __init__(self, ring: BufferRing | None, slot: Slot):
        self.ring, self.slot, self.seq = ring, slot, slot.seq
        self._released = False

    @contextlib.contextmanager
    def launch(self):
        """The block fills the slot and puts the copies and the launch on
        the current stream; the slot's event is recorded behind them.  An
        error releases the slot (after the event behind whatever reached
        the stream) and propagates."""
        try:
            yield self.slot
        except BaseException:
            self.slot.record()
            self.release()
            raise
        self.slot.record()

    def collect(self, read):
        """Waits for the event, returns ``read(slot)`` (which copies the
        result out of the slot), and releases the slot."""
        try:
            self.slot.wait()
            return read(self.slot)
        finally:
            self.release()

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        if self.ring is not None:
            self.ring.release(self.slot, self.seq)
        else:
            self.slot.wait()


def lease(key: str, spec: dict, device: torch.device, *, width: str) -> Lease:
    """A slot for one launch: from the ring ``key`` when the rings are on
    (a fresh slot when that ring is saturated), else a throwaway one."""
    if not enabled():
        return Lease(None, _owned(Slot(spec, device)))
    ring = ring_for(key, spec, device, width=width)
    slot = ring.acquire()
    return Lease(ring, slot) if slot is not None else Lease(None, ring.fresh())


def ring_for(key: str, spec: dict, device: torch.device, *, slots: int | None = None,
             width: str = "all") -> BufferRing:
    """The process-wide ring for ``key`` (created on first use).

    ``key`` names the whole padded shape family and the device (e.g.
    ``pow:64:1024:512:64:cuda:0``), so a new shape mints a new ring.
    """
    with _lock:
        r = _RINGS.get(key)
        if r is None:
            r = _RINGS[key] = BufferRing(key, spec, device, slots=slots, width=width)
        return r


def stats() -> dict:
    """Per-ring occupancy snapshot."""
    with _lock:
        return {
            key: {
                "width": r.width,
                "slots": len(r._slots),
                "in_flight": sum(1 for s in r._slots if s.in_flight),
                "acquires": r.acquires,
                "overflows": r.overflows,
            }
            for key, r in _RINGS.items()
        }


def reset() -> None:
    """Drops every ring (tests; call only with no launch in flight)."""
    with _lock:
        _RINGS.clear()
