"""Elastic topology autopilot (counterpart of ``bftkv_tpu/autopilot/``).

Detect → decide → execute for live topology changes: epoched route
tables (``quorum/wotqs.RouteTable``), hot-shard splits, clique
retirement under traffic, and spare-replica admission, all riding the
background anti-entropy and repair planes, never the write's one-round
critical path.

- :mod:`bftkv_tpu_torch.autopilot.plan`: pure decisions (split / retire);
- :mod:`bftkv_tpu_torch.autopilot.daemon`: the 3-phase executor
  (pre-copy → flip → drain) and the watch loop;
- ``python -m bftkv_tpu_torch.autopilot``: the advisory watcher over a
  ``/fleet`` endpoint (``run_cluster --autopilot`` boots it).

The autopilot takes no device: it acts on nodes that were built on one.
``BFTKV_AUTOPILOT=off`` disables automatic decisions.
"""

from bftkv_tpu_torch.autopilot.daemon import Autopilot, autopilot_enabled
from bftkv_tpu_torch.autopilot.plan import Plan, decide, next_table

__all__ = [
    "Autopilot",
    "Plan",
    "autopilot_enabled",
    "decide",
    "next_table",
]
