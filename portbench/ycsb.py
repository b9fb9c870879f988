"""The one traffic generator: YCSB's core workload, read from a mix's data file.

A mix (``portbench/traffic/<name>.json``) sets YCSB's core properties:
``recordcount``, ``fieldlength``, ``readproportion``,
``updateproportion``, ``insertproportion`` and ``requestdistribution``
(``uniform`` or ``zipfian``, the latter scrambled as YCSB's
``ScrambledZipfianGenerator`` with ``zipfian_constant`` 0.99); keys are
YCSB's hashed insert order, ``user`` + FNV-64 of the record number; and the
harness's: ``clients`` (closed-loop client identities, one thread
each) and ``batch`` (operations per call: 1 issues ``read``/``write``,
more issue ``read_many``/``write_many``).

Record ``i`` of the preload belongs to client ``i mod clients``: BFTKV
variables are trust-on-first-write, so a client updates only the records
it wrote, and an update draws over its own records.  Reads draw over all
records.  Inserts take fresh record numbers, client ``c`` the numbers
``recordcount + c + clients·k``.  Every draw comes from the seed: client
``c``'s stream from ``random.Random(f"{seed}/client/{c}")``, the preload's
values from ``random.Random(f"{seed}/preload/{c}")``.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass

__all__ = ["Mix", "Op", "Workload", "fnvhash64", "load_mix"]

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 1099511628211
_M64 = (1 << 64) - 1

#: YCSB's ScrambledZipfianGenerator: a zipfian over 10^10 items, with the
#: zeta constant it precomputes for theta 0.99, folded onto the record
#: count by FNV-64.
_ZIPF_ITEMS = 10_000_000_000
_ZIPF_ZETAN = 26.46902820178302
_ZIPF_THETA = 0.99

KEYS = ("clients", "batch", "recordcount", "fieldlength", "readproportion", "updateproportion",
        "insertproportion", "requestdistribution", "zipfian_constant")


def fnvhash64(val: int) -> int:
    """YCSB's ``Utils.fnvhash64``: FNV-1 over the 8 little-endian bytes of
    a Java long, then ``Math.abs``."""
    h = _FNV_OFFSET
    val &= _M64
    for _ in range(8):
        h ^= val & 0xFF
        val >>= 8
        h = (h * _FNV_PRIME) & _M64
    if h >= 1 << 63:
        h -= 1 << 64
    return abs(h) if h != -(1 << 63) else h


@dataclass(frozen=True)
class Mix:
    clients: int
    batch: int
    recordcount: int
    fieldlength: int
    readproportion: float
    updateproportion: float
    insertproportion: float
    requestdistribution: str = "zipfian"
    zipfian_constant: float = _ZIPF_THETA


def load_mix(path: str) -> Mix:
    with open(path) as f:
        raw = json.load(f)
    mix = Mix(**{k: raw[k] for k in KEYS if k in raw})
    total = mix.readproportion + mix.updateproportion + mix.insertproportion
    if abs(total - 1.0) > 1e-9:
        raise ValueError(f"{os.path.basename(path)}: proportions sum to {total}, not 1")
    if mix.requestdistribution not in ("uniform", "zipfian"):
        raise ValueError(f"requestdistribution {mix.requestdistribution!r}")
    if mix.requestdistribution == "zipfian" and mix.zipfian_constant != _ZIPF_THETA:
        raise ValueError("the scrambled zipfian is defined for zipfian_constant 0.99 only")
    if mix.updateproportion and mix.recordcount // mix.clients < mix.batch:
        raise ValueError("a call's updates need as many records per client as the batch")
    return mix


@dataclass(frozen=True)
class Op:
    kind: str  # "read", "update" or "insert"
    key: bytes
    value: bytes | None = None


class _ScrambledZipfian:
    def __init__(self, items: int):
        self.items = items
        theta = _ZIPF_THETA
        self.alpha = 1.0 / (1.0 - theta)
        zeta2 = 1.0 + 0.5 ** theta
        self.half_pow = 0.5 ** theta
        self.eta = (1 - (2.0 / _ZIPF_ITEMS) ** (1 - theta)) / (1 - zeta2 / _ZIPF_ZETAN)

    def next(self, rng: random.Random) -> int:
        u = rng.random()
        uz = u * _ZIPF_ZETAN
        if uz < 1.0:
            v = 0
        elif uz < 1.0 + self.half_pow:
            v = 1
        else:
            v = int(_ZIPF_ITEMS * (self.eta * u - self.eta + 1) ** self.alpha)
        return fnvhash64(v) % self.items


class Workload:
    """The operations of one run of ``mix`` under ``seed``."""

    def __init__(self, mix: Mix, seed: int):
        self.mix = mix
        self.seed = seed

    def key(self, recno: int) -> bytes:
        return b"user%d" % fnvhash64(recno)

    def own_records(self, client: int) -> list[int]:
        return list(range(client, self.mix.recordcount, self.mix.clients))

    def preload(self, client: int) -> list[tuple[bytes, bytes]]:
        """The (key, value) records ``client`` loads before the run."""
        rng = random.Random(f"{self.seed}/preload/{client}")
        return [(self.key(i), rng.randbytes(self.mix.fieldlength)) for i in self.own_records(client)]

    def stream(self, client: int):
        """``client``'s endless stream of calls, each a list of ``batch``
        operations."""
        mix = self.mix
        rng = random.Random(f"{self.seed}/client/{client}")
        own = self.own_records(client)
        dist_all = _ScrambledZipfian(mix.recordcount) if mix.recordcount else None
        dist_own = _ScrambledZipfian(len(own)) if own else None
        next_insert = mix.recordcount + client

        def draw(dist, n: int) -> int:
            if mix.requestdistribution == "uniform":
                return rng.randrange(n)
            return dist.next(rng)

        while True:
            ops: list[Op] = []
            written: set[bytes] = set()
            while len(ops) < mix.batch:
                r = rng.random()
                if r < mix.readproportion:
                    ops.append(Op("read", self.key(draw(dist_all, mix.recordcount))))
                    continue
                if r < mix.readproportion + mix.updateproportion:
                    key = self.key(own[draw(dist_own, len(own))])
                    if key in written:  # one call writes a variable once
                        continue
                    ops.append(Op("update", key, rng.randbytes(mix.fieldlength)))
                else:
                    key = self.key(next_insert)
                    next_insert += mix.clients
                    ops.append(Op("insert", key, rng.randbytes(mix.fieldlength)))
                written.add(key)
            yield ops
