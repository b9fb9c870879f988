"""Closed-loop clients: one thread per client identity, each issuing its
stream's calls back to back through the port's ``Client``.

Every call is logged with the host clock around it and each operation's
answer: for a write, whether the system acknowledged it; for a read, the
value it returned.  ``window`` releases all clients together, and each stops
issuing at the deadline; calls in flight then finish and are logged too.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from portbench.ycsb import Op

__all__ = ["Call", "Driver"]


@dataclass
class Call:
    client: int
    ops: list[Op]
    issued: float
    answered: float | None = None
    #: Per op: True/False for a write (acknowledged or not), the value (or
    #: None) for a read that answered, an exception for a read that failed.
    results: list = field(default_factory=list)


def _execute(client, ops: list[Op]) -> list:
    reads = [op for op in ops if op.kind == "read"]
    writes = [op for op in ops if op.kind != "read"]
    out: dict[int, object] = {}
    if len(ops) == 1:
        op = ops[0]
        try:
            if op.kind == "read":
                out[id(op)] = client.read(op.key)
            else:
                client.write(op.key, op.value)
                out[id(op)] = True
        except Exception as e:  # an answer that says the operation failed
            out[id(op)] = False if op.kind != "read" else e
        return [out[id(op)]]
    if writes:
        try:
            errs = client.write_many([(op.key, op.value) for op in writes])
        except Exception:  # the whole call failed: no write acknowledged
            errs = [RuntimeError] * len(writes)
        for op, err in zip(writes, errs):
            out[id(op)] = err is None
    if reads:
        try:
            vals = client.read_many([op.key for op in reads])
        except Exception as e:
            vals = [e] * len(reads)
        for op, v in zip(reads, vals):
            out[id(op)] = v
    return [out[id(op)] for op in ops]


class Driver:
    def __init__(self, clients: list, streams: list):
        self.clients = clients
        self.streams = streams
        self.calls: list[list[Call]] = [[] for _ in clients]

    def _loop(self, i: int, start: threading.Barrier, go) -> None:
        client, stream, log = self.clients[i], self.streams[i], self.calls[i]
        start.wait()
        n = 0
        while go(n):
            call = Call(i, next(stream), time.perf_counter())
            log.append(call)
            call.results = _execute(client, call.ops)
            call.answered = time.perf_counter()
            n += 1

    def _release(self, seconds: float | None, calls: int | None, on_start=None):
        start = threading.Barrier(len(self.clients) + 1)
        deadline = [float("inf")]

        def more(n: int) -> bool:
            return (calls is None or n < calls) and time.perf_counter() < deadline[0]

        threads = [threading.Thread(target=self._loop, args=(i, start, more), daemon=True)
                   for i in range(len(self.clients))]
        for t in threads:
            t.start()
        if on_start is not None:
            on_start()
        t0 = time.perf_counter()
        if seconds is not None:
            deadline[0] = t0 + seconds
        start.wait()
        return t0, deadline[0], threads

    def warm(self, calls: int, timeout: float) -> None:
        """Every client issues its next ``calls`` calls; waits for all."""
        _t0, _end, threads = self._release(None, calls)
        if self.join(threads, time.perf_counter() + timeout):
            raise RuntimeError(f"the warm-up's calls did not finish in {timeout} s")

    def window(self, seconds: float, on_start=None) -> tuple[float, float, list[threading.Thread]]:
        """Every client issues calls until ``seconds`` have passed.
        ``on_start`` runs just before the release.  Returns at the deadline
        with the window's start and deadline on the host clock, and the
        client threads, which finish the calls in flight."""
        t0, end, threads = self._release(seconds, None, on_start)
        time.sleep(max(0.0, end - time.perf_counter()))
        return t0, end, threads

    @staticmethod
    def join(threads: list[threading.Thread], until: float) -> list[threading.Thread]:
        """Waits for ``threads`` until ``until``; returns those still running."""
        for t in threads:
            t.join(max(0.0, until - time.perf_counter()))
        return [t for t in threads if t.is_alive()]
