"""Per-layer metrics: what a reader gets, and how the harness finds it.

The reader of metric ``name`` is ``portbench/layer_metrics/<name>.py``,
or, for a metric family ``<family>.<suffix>``, the family's
``portbench/layer_metrics/<family>.py``.  It defines ``read(ctx)``, which
returns the metric's value, or ``None`` where the window holds nothing to
read; a ``None`` leaves the metric out of the result line.
"""

from __future__ import annotations

import importlib.util
import os
from dataclasses import dataclass, field

from portbench.devtrace import DeviceTrace
from portbench.driver import Call

__all__ = ["Context", "find_reader"]

READERS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "layer_metrics")


@dataclass
class Context:
    """What one traced window left to read."""

    window_s: float
    #: Registry counters and sample sums/counts, end of window less start.
    registry: dict[str, float]
    #: Calls issued inside the window that were answered by its end.
    calls: list[Call]
    trace: DeviceTrace | None
    launches: list = field(default_factory=list)
    unmodelled: dict = field(default_factory=dict)

    def timer_ms(self, name: str) -> float | None:
        """Mean milliseconds of the registry timer ``name`` over the window."""
        n = self.registry.get(f"{name}.count", 0)
        return 1e3 * self.registry.get(f"{name}.sum", 0.0) / n if n > 0 else None

    def ratio(self, num: str, den: str) -> float | None:
        d = self.registry.get(den, 0)
        return self.registry.get(num, 0) / d if d > 0 else None


def find_reader(name: str, readers: str | None = None):
    """The ``read`` function of metric ``name``'s reader file in
    ``readers`` (default the harness's ``layer_metrics``)."""
    readers = readers or READERS
    for stem in (name, name.split(".")[0]):
        path = os.path.join(readers, f"{stem}.py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(f"portbench_layer_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for per-layer metric {name!r} in {readers}")
