"""Fleet health plane of the port (counterpart of ``bftkv_tpu/obs``):
cross-process observability for a sharded fleet.  Host code only: the
collector and ``cmd.fleet`` take no device and never initialise CUDA.

- :mod:`bftkv_tpu_torch.obs.source` — where fleet state comes from: one
  :class:`~bftkv_tpu_torch.obs.source.HTTPSource` per daemon API (scrapes
  ``/info`` + ``/metrics`` + ``/trace?since=``), or
  :class:`~bftkv_tpu_torch.obs.source.LocalSource` for in-process
  clusters (the chaos harness);
- :mod:`bftkv_tpu_torch.obs.stitch` — joins every process's exported
  spans into one tree per trace id;
- :mod:`bftkv_tpu_torch.obs.collector` — the
  :class:`~bftkv_tpu_torch.obs.collector.FleetCollector`: per-shard
  f-budget, merged fixed-bucket SLO histograms with slow-trace
  exemplars, and the anomaly feed;
- :mod:`bftkv_tpu_torch.obs.http` — ``/fleet`` as JSON and Prometheus
  text;
- :mod:`bftkv_tpu_torch.obs.critpath` — exclusive-time decomposition of
  each stitched write/read trace over the closed ``trace.PHASES`` enum;
- :mod:`bftkv_tpu_torch.obs.profiler` — opt-in wall-clock sampling
  profiler (``/profile?seconds=N`` per daemon);
- :mod:`bftkv_tpu_torch.obs.recorder` — the flight recorder:
  anomaly-driven, rate-limited, size-capped black-box bundles;
- :mod:`bftkv_tpu_torch.obs.capacity` — the USE-method capacity plane
  over the closed resource vocabulary, whose ``dispatch`` row reads the
  card dispatchers' occupancy gauges.

Entry points: ``python -m bftkv_tpu_torch.cmd.fleet`` (one-shot,
``--watch``, ``--listen``, ``--budget``, ``--capacity``, ``--bundle``)
and ``run_cluster --fleet``.
"""

from bftkv_tpu_torch.obs.capacity import CapacityPlane
from bftkv_tpu_torch.obs.collector import FleetCollector
from bftkv_tpu_torch.obs.critpath import PhaseBudget, attribute
from bftkv_tpu_torch.obs.recorder import FlightRecorder
from bftkv_tpu_torch.obs.source import HTTPSource, LocalSource
from bftkv_tpu_torch.obs.stitch import Stitcher

__all__ = [
    "CapacityPlane",
    "FleetCollector",
    "FlightRecorder",
    "HTTPSource",
    "LocalSource",
    "PhaseBudget",
    "Stitcher",
    "attribute",
]
