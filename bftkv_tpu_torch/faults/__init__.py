"""Fault injection of the port (counterpart of ``bftkv_tpu/faults``):
:mod:`bftkv_tpu_torch.faults.failpoint`, the seeded failpoint registry;
:mod:`~bftkv_tpu_torch.faults.byzantine`, Byzantine behaviours as failpoint
programs; :mod:`~bftkv_tpu_torch.faults.checker`, the history recorder and
safety checker; :mod:`~bftkv_tpu_torch.faults.harness`, the in-process chaos
cluster; :mod:`~bftkv_tpu_torch.faults.nemesis`, the seeded chaos schedules
(``python -m bftkv_tpu_torch.faults.nemesis --seed 7``); and
:func:`default_chaos_program`, the daemon's ``--chaos-seed`` program."""

from bftkv_tpu_torch.faults.failpoint import (
    Action,
    FaultEvent,
    FaultRegistry,
    Rule,
    arm,
    disarm,
    fire,
    registry,
)

__all__ = [
    "Action",
    "FaultEvent",
    "FaultRegistry",
    "Rule",
    "arm",
    "disarm",
    "fire",
    "registry",
    "default_chaos_program",
]


def default_chaos_program(reg: FaultRegistry) -> list:
    """The light background chaos a daemon arms under ``--chaos-seed``:
    seeded transport delays and rare drops plus occasional anti-entropy
    round aborts.  Deliberately inside the ``f`` budget — a fleet under
    this program must stay fully correct, only slower."""
    return [
        reg.add(
            "transport.send", "delay",
            prob=0.10, seconds=0.01, max_seconds=0.05,
            rule_id="default:delay",
        ),
        reg.add("transport.send", "drop", prob=0.02, rule_id="default:drop"),
        reg.add("sync.round", "abort", prob=0.10, rule_id="default:abort"),
    ]
