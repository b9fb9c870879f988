"""Observability of the port (counterpart of ``bftkv_tpu/obs``).

Ported so far:

- :mod:`bftkv_tpu_torch.obs.source` — a fleet member's scrape surface:
  :class:`~bftkv_tpu_torch.obs.source.HTTPSource` over a daemon's API,
  :class:`~bftkv_tpu_torch.obs.source.LocalSource` over an in-process
  server, and ``seat_document`` behind the daemon's ``/info``;
- :mod:`bftkv_tpu_torch.obs.profiler` — the opt-in wall-clock sampling
  profiler behind ``/profile?seconds=N``.

The fleet collector, stitcher, critical path, flight recorder, capacity
plane and ``/fleet`` HTTP surface are not ported yet.
"""

from bftkv_tpu_torch.obs.source import HTTPSource, LocalSource

__all__ = ["HTTPSource", "LocalSource"]
