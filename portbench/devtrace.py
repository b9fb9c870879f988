"""The device's side of a traced window, from ``torch.profiler``.

The window is profiled with CUDA activity only (CUPTI): every kernel,
copy and memset the card ran, with its start and length.  The trace is
exported to a file under ``TMPDIR``, read back and deleted.  Busy time is
the union of those intervals; idle gaps are the holes between them.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass

__all__ = ["DeviceTrace", "Profiler"]

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class DeviceTrace:
    #: (start us, end us, full name) of every device operation, by start.
    ops: list[tuple[float, float, str]]

    def busy_s(self) -> float:
        busy, end = 0.0, float("-inf")
        for s, e, _n in self.ops:
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy / 1e6

    def kernel_time(self, fragment: str) -> tuple[float, int]:
        """Seconds and count of the operations whose name holds ``fragment``."""
        total, count = 0.0, 0
        for s, e, n in self.ops:
            if fragment in n:
                total += e - s
                count += 1
        return total / 1e6, count

    def top_ops(self, k: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for s, e, n in self.ops:
            by[_short(n)] = by.get(_short(n), 0.0) + (e - s) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """The longest holes between device operations, each named by the
        operation it follows."""
        gaps = []
        end, last = None, None
        for s, e, n in self.ops:
            if end is not None and s > end:
                gaps.append([f"after {last}", (s - end) / 1e6])
            if end is None or e > end:
                end, last = e, _short(n)
        return sorted(gaps, key=lambda g: -g[1])[:k]


def _short(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].strip()[:120] or "unnamed"


class Profiler:
    """``torch.profiler`` over the window, CUDA activity only (host
    activity where the machine has no card, which records no device
    operation)."""

    def __init__(self):
        import torch

        act = torch.profiler.ProfilerActivity
        self._prof = torch.profiler.profile(
            activities=[act.CUDA if torch.cuda.is_available() else act.CPU])

    def start(self) -> None:
        self._prof.__enter__()

    def stop(self) -> DeviceTrace:
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        ops = [(float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)), ev.get("name", ""))
               for ev in events
               if ev.get("ph") == "X" and ev.get("cat") in _DEVICE_CATS]
        ops.sort()
        return DeviceTrace(ops)
