"""Production workload engine (DESIGN.md §23).

Counterpart of ``bftkv_tpu/workload/__init__.py``.

Three cooperating layers, all seeded-deterministic:

- :mod:`bftkv_tpu_torch.workload.spec` — declarative :class:`WorkloadSpec`
  (op mix, key popularity, value sizes, arrival program), every
  probabilistic draw via the sha256(seed|stream|counter) discipline the
  faults registry already uses, so one seed replays one workload;
- :mod:`bftkv_tpu_torch.workload.driver` — open-loop execution with
  coordinated-omission-corrected latency on the fleet-wide
  ``metrics.BUCKETS`` ladder, in-process (threads) and multi-process
  (worker processes over the HTTP transport), merged by bucket-vector
  summation;
- :mod:`bftkv_tpu_torch.workload.universe` — planet-scale synthetic trust
  universes (10k–100k nodes) with churn / revocation-storm schedules
  and the scaling profiler.
"""

from bftkv_tpu_torch.workload.spec import (  # noqa: F401
    OP_KINDS,
    Op,
    PRESETS,
    WorkloadSpec,
    parse_spec,
)
from bftkv_tpu_torch.workload.driver import (  # noqa: F401
    LatencyHist,
    OpenLoop,
    merge_reports,
    run_in_process,
    run_multiprocess,
)
