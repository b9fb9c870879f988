"""The port's registry of the ``BFTKV_*`` environment flags it reads.

Same seam as ``bftkv_tpu/flags.py`` (:func:`raw`, :func:`get`,
:func:`enabled`): every read goes through here, and reading an
undeclared name raises ``KeyError``, so a flag cannot ship
undocumented.  The port keeps its own registry because the reference's
raises on names it does not declare and declares many the port does not
read yet; each later slice adds the names it starts to read.
"""

from __future__ import annotations

import os
from typing import NamedTuple

__all__ = ["Flag", "FLAGS", "declared", "enabled", "get", "get_float", "get_int", "raw"]


class Flag(NamedTuple):
    name: str
    default: str | None  # None = unset (the call site's fallback applies)
    kind: str  # "switch" | "str" | "int" | "float"
    doc: str


FLAGS: dict[str, Flag] = {}


def _flag(name: str, default: str | None, kind: str, doc: str) -> None:
    if not name.startswith("BFTKV_") or name in FLAGS:
        raise ValueError(f"bad or duplicate flag declaration {name!r}")
    FLAGS[name] = Flag(name, default, kind, doc)


_flag("BFTKV_HOST_VERIFY_THRESHOLD", None, "int",
      "Batch size below which verifies stay on host (unset: "
      "VerifierDomain.HOST_CROSSOVER, or the dispatcher's calibration).")
_flag("BFTKV_HOST_SIGN_THRESHOLD", None, "int",
      "Batch size below which signs stay on host (unset: "
      "SignerDomain.HOST_CROSSOVER, or the dispatcher's calibration).")
_flag("BFTKV_DISPATCH_CROSSOVER", None, "int",
      "Operator override for the host/device verify crossover batch size "
      "(0 or negative pins always-host; unset: measured by calibration).")
_flag("BFTKV_VERIFY_BACKEND", "rns", "str",
      "RSA verify backend of VerifierDomain: `rns` (default, kernel K1), "
      "`limb` (the limb Montgomery engine in PyTorch ops), `pallas` (the "
      "limb chain as kernel K3; 2048-bit only).")
_flag("BFTKV_SIGN_BACKEND", "rns", "str",
      "RSA sign backend of SignerDomain: `rns` (default, kernel K2; groups "
      "the RNS bases decline go to the limb engine) or `limb`.")
_flag("BFTKV_TPU_MIN_MODEXP_BATCH", "4", "int",
      "BatchModExp batches below this size run as host pow.")
_flag("BFTKV_DISPATCH_CALIBRATE", "1", "switch",
      "Start-time host-vs-device crossover calibration of the dispatchers "
      "(`0` disables; a CPU device still pins always-host).")
_flag("BFTKV_DISPATCH_PIPELINE", None, "int",
      "Flushes in flight at once in a batching dispatcher (unset: 2 on a "
      "cuda device, 1 on the cpu).")
_flag("BFTKV_DISPATCH_ASYNC", "on", "switch",
      "Async dispatch: a flush whose dispatcher has a non-blocking launch "
      "(ModexpDispatcher) hands it to one completion-drain thread, which "
      "finalizes launches FIFO; `off` restores fully synchronous flushes.")
_flag("BFTKV_DISPATCH_DEVBUF", "on", "switch",
      "Persistent staging rings (ops/devbuf.py): launches write their "
      "operands into preallocated pinned host and device tensors; `off` "
      "allocates per launch.")
_flag("BFTKV_DISPATCH_DEVBUF_RING", "4", "int",
      "Slots per staging ring; with every slot in flight the next launch "
      "allocates a fresh one (devbuf.overflow) instead of blocking.")
_flag("BFTKV_EC_BACKEND", "auto", "str",
      "EC scalar-mult engine: `rns` (kernel K5 on `cuda`, its plain version "
      "on `cpu`), `limb` (the limb engine in PyTorch ops), `auto` (default: "
      "`rns` on a `cuda` device, `limb` on the `cpu`).")
_flag("BFTKV_EC_SIGN_THRESHOLD", None, "int",
      "ECDSA batch size below which signs stay on host (unset: "
      "ecdsa.SIGN_HOST_CROSSOVER).")
_flag("BFTKV_EC_VERIFY_THRESHOLD", None, "int",
      "ECDSA batch size below which verifies stay on host (unset: "
      "ecdsa.VERIFY_HOST_CROSSOVER).")
_flag("BFTKV_AUTOPILOT", "on", "switch",
      "Automatic topology decisions (hot-shard split, clique retirement; "
      "autopilot/); `off` disables deciding only: forced executes stay "
      "available.")
_flag("BFTKV_SHARD", "auto", "str",
      "Split of the RNS verify and sign launches over every local cuda device "
      "(ops/rns.py, contiguous row shards); `off` pins one device.")
_flag("BFTKV_DISPATCH_RECAL_S", "60", "float",
      "Sidecar online-recalibration period in seconds: the boot-time "
      "crossover pin is re-measured from observed launch RTTs, so an "
      "attached accelerator engages without a restart (0 disables).")
_flag("BFTKV_SIDECAR_SIGN", "on", "switch",
      "Clients remote their RSA signing to the shared sidecar when the "
      "channel can carry keys (unix socket or HMAC secret); `off` keeps "
      "signing in-process (verification still remotes).")
_flag("BFTKV_SIDECAR_SPOT_RATE", "0.05", "float",
      "Fraction of remote verify batches whose verdicts are re-checked "
      "locally on one sampled item; a mismatch opens the sidecar "
      "breaker and raises crypto.sidecar.dishonest.")
_flag("BFTKV_SIDECAR_BREAKER", "30", "float",
      "Seconds the sidecar breaker skips the service after a transport "
      "failure or a dishonest result before retrying.")
_flag("BFTKV_SIDECAR_MAX_INFLIGHT", "4", "int",
      "Sidecar admission: crypto batches served concurrently; more "
      "wait, then shed (sidecar.shed).")
_flag("BFTKV_SIDECAR_MAX_QUEUE", "64", "int",
      "Sidecar admission: batches allowed to WAIT for a service slot "
      "before instant shedding.")
_flag("BFTKV_SIDECAR_MAX_WAIT", "0.5", "float",
      "Sidecar admission: longest a batch may wait for a service slot "
      "before it is shed.")
_flag("BFTKV_SIDECAR_MAX_KEYS", "64", "int",
      "Sign-key handles one sidecar connection may register (bounds "
      "hostile registration floods).")
_flag("BFTKV_VERIFY_CACHE", "1", "switch",
      "Verified-signature memo (crypto/vcache.py); `0` disables every "
      "lookup and seeding.")
_flag("BFTKV_VERIFY_CACHE_MAX", "65536", "int",
      "Entries of the verified-signature memo (LRU).")
_flag("BFTKV_NATIVE_MODEXP", "auto", "str",
      "`off` keeps host RSA signing and the host modexp tier on Python's "
      "pow instead of native/montmodexp.c (built into _build/native/).")
_flag("BFTKV_NATIVE_CODEC", "auto", "str",
      "`off` keeps the packet codec pure Python instead of "
      "native/packetcodec.c (built into _build/native/).")
_flag("BFTKV_OS_RNG", "", "switch",
      "`1` makes crypto/rng.generate_random read os.urandom on every call "
      "instead of the per-thread hash-DRBG.")
_flag("BFTKV_TRACE", "on", "switch",
      "Trace-id/span plane (trace.py); `off` disables tracing entirely.")
_flag("BFTKV_SLOW_TRACE_SECONDS", "1.0", "float",
      "Slow-trace threshold: root spans above it land in the slow ring and "
      "the one-JSON-line slow log.")
_flag("BFTKV_LOCKWATCH", "", "switch",
      "Opt-in runtime lock sanitizer (devtools/lockwatch.py): lock-order "
      "cycles and blocking calls under watched locks.")
_flag("BFTKV_REGION", None, "str",
      "This process's own region label, overriding the installed "
      "region map (a gateway box pinned to its serving region; "
      "unset: the identity's label from the universe's regions "
      "file).")
_flag("BFTKV_WAN_JITTER", "0", "float",
      "Fractional jitter on WAN link delays: each one-way delay "
      "stretches uniformly (seeded per-rule draw) up to "
      "delay x (1 + jitter).")
_flag("BFTKV_WAN_RTT_MATRIX", None, "str",
      "Named geo-topology (wan2, wan3) or raw ms spec (e.g. "
      "20/80/150) compiled onto the link plane as quiet background "
      "delay rules: the chaos nemesis's `--rtt-matrix` default.")
_flag("BFTKV_PLAIN_FSYNC", None, "switch",
      "Per-write fsync pair (file + directory) in PlainStorage; "
      "unset: library off / daemon on (durability is a deployment "
      "policy).")
_flag("BFTKV_PLAIN_CACHE", "1024", "int",
      "PlainStorage write-through record cache (entries; 0 disables).")
_flag("BFTKV_STORAGE", None, "str",
      "Default `--storage` engine for the daemon/cluster CLIs "
      "(plain|log|native|mem; unset: plain for the daemon, log for "
      "run_cluster).")
_flag("BFTKV_LOG_SEGMENT_MB", "64", "int",
      "LogStorage segment size: the active segment seals past this "
      "and becomes a shippable snapshot unit (DESIGN.md §19).")
_flag("BFTKV_LOG_GROUP_COMMIT_MS", "2", "float",
      "LogStorage group-commit linger: how long the fsync leader "
      "waits for concurrent writers to join its barrier (0 = fsync "
      "immediately, still shared by the losers of the leader race).")
_flag("BFTKV_LOG_COMPACT_TRIGGER", "0.5", "float",
      "LogStorage background compaction trigger: sealed dead-byte "
      "ratio past which a compaction pass starts (0 disables).")
_flag("BFTKV_LOG_COMPACT_MBPS", None, "float",
      "Compaction IO governor: sustained copy-rate cap in MB/s "
      "(token-bucket sleep between record copies; unset/0 = "
      "ungoverned).  Throttle time surfaces as compact_io saturation "
      "in the capacity plane.")

# Transport, protocol and sync (the reference's defaults).
_flag("BFTKV_ADAPTIVE_FLOOR", '1.0', "float",
      "Lower bound in seconds on an adaptive per-peer deadline.")
_flag("BFTKV_ADAPTIVE_TIMEOUT", 'on', "switch",
      "Per-peer EWMA/p99 RPC deadlines in place of the fixed "
      "BFTKV_RPC_TIMEOUT (which stays the ceiling).")
_flag("BFTKV_FANOUT_WORKERS", '256', "int",
      "Bound on the shared multicast fan-out worker pool.")
_flag("BFTKV_HEDGE", 'on', "switch",
      "Hedged staged fan-outs: a stalled wave launches the next wave "
      "early after a p99-derived delay.")
_flag("BFTKV_HEDGE_CAP", '0.5', "float",
      "Upper clamp in seconds on the hedge delay.")
_flag("BFTKV_HEDGE_MIN", '0.02', "float",
      "Lower clamp in seconds on the hedge delay.")
_flag("BFTKV_HTTP_POOL", '4', "int",
      "Idle keep-alive connections kept per (host, port).")
_flag("BFTKV_HTTP_TIMEOUT", None, "float",
      "Legacy alias for BFTKV_RPC_TIMEOUT, read only when that is "
      "unset.")
_flag("BFTKV_INLINE_FANOUT", 'auto', "str",
      "`auto` runs loopback multicast inline when calibration says "
      "all-host; `off`/`on` force the threaded/inline path.")
_flag("BFTKV_PEER_CB", '', "switch",
      "Per-peer circuit breaker in multicast (`1` enables; default "
      "off).")
_flag("BFTKV_PEER_CB_OPEN_SECS", '5', "float",
      "Seconds an open breaker skips a peer before the half-open "
      "probe.")
_flag("BFTKV_PEER_CB_THRESHOLD", '3', "int",
      "Consecutive failures before a peer's breaker opens.")
_flag("BFTKV_PIGGYBACK", 'on', "switch",
      "Round-collapsed writes: one WRITE_SIGN fan-out with signature "
      "shares riding the acks; `off` restores classic time/sign/write "
      "rounds (DESIGN.md §12).")
_flag("BFTKV_PRESESSION", 'on', "switch",
      "Background session pump + per-client timestamp leases (skips "
      "the TIME round on steady-state writes).")
_flag("BFTKV_REGION_RANK", 'on', "switch",
      "Locality-aware quorum staging: staged waves order candidates "
      "same-region-first (then by RTT matrix distance) so the minimal "
      "sufficient prefix is the near one and cross-region members are "
      "hedges, not the first ask.  Never changes which sets satisfy "
      "is_threshold/is_sufficient (DESIGN.md §21).")
_flag("BFTKV_REPAIR", 'on', "switch",
      "Pending-residue repair plane: each replica certifies-or- "
      "demotes its own commit-pending residue (DESIGN.md §13).")
_flag("BFTKV_REPAIR_AFTER", '5', "float",
      "Grace window in seconds before a pending record becomes "
      "repair-eligible.")
_flag("BFTKV_RPC_BACKOFF", '0.05', "float",
      "Base backoff in seconds between transport retries.")
_flag("BFTKV_RPC_RETRIES", '0', "int",
      "Bounded jittered-backoff retries on transient transport errors "
      "(0 disables).")
_flag("BFTKV_RPC_TIMEOUT", None, "float",
      "Fixed per-RPC response deadline ceiling in seconds (unset: "
      "falls back to BFTKV_HTTP_TIMEOUT, then 10).")
_flag("BFTKV_SIGN_FANOUT", 'staged', "str",
      "`staged` asks a minimal sufficient prefix first and expands on "
      "shortfall; `full` restores the ask-everyone fan-out.")
_flag("BFTKV_WRITE_CHUNK", '256', "int",
      "write_many chunk floor — batches at or below this stay "
      "monolithic so device launches amortize.")
_flag("BFTKV_WRITE_PIPELINE", '2', "int",
      "write_many: chunk write-rounds in flight behind the caller's "
      "time+sign rounds (1 disables pipelining).")

# The process surfaces: daemon, gateway, workload driver.
_flag("BFTKV_PROFILE", "", "switch",
      "Opt-in continuous wall-clock sampling profiler (collapsed "
      "flamegraph stacks served on /profile).  Off = no sampler "
      "thread, zero overhead.")
_flag("BFTKV_PROFILE_HZ", "67", "int",
      "Sampling rate of the continuous profiler (prime default so the "
      "comb never phase-locks to periodic work).")
_flag("BFTKV_GIL_SAMPLER", "1", "switch",
      "GIL-pressure estimate (runnable-thread gauge) riding the "
      "profiler tick; costs nothing while the profiler is disarmed.")
_flag("BFTKV_SLO_WRITE_P99", None, "float",
      "Write-latency SLO in seconds: a shard whose per-scrape write "
      "p99 exceeds it for BFTKV_SLO_BURN_SCRAPES consecutive scrapes "
      "raises the slo_burn anomaly (unset: disabled).")
_flag("BFTKV_SLO_BURN_SCRAPES", "3", "int",
      "Consecutive breaching scrapes before slo_burn fires.")
_flag("BFTKV_FLIGHT_RECORDER", "", "switch",
      "Arm the flight recorder in the chaos nemesis: every fault "
      "window must yield exactly one black-box bundle naming the "
      "detected anomaly, enforced via the nemesis exit code.")
_flag("BFTKV_RECORDER_DIR", None, "str",
      "Flight-recorder bundle directory (unset: <tmpdir>/"
      "bftkv-blackbox).")
_flag("BFTKV_RECORDER_MIN_INTERVAL", "5", "float",
      "Seconds within which anomaly events coalesce into (amend) the "
      "previous bundle instead of minting a new one.")
_flag("BFTKV_RECORDER_MAX_MB", "64", "int",
      "Total on-disk cap across flight-recorder bundles; oldest "
      "bundles are evicted first.")
_flag("BFTKV_SAT_THRESHOLD", "0.8", "float",
      "Capacity plane: per-resource saturation at or above this for "
      "BFTKV_SAT_SCRAPES consecutive traffic-bearing scrapes raises "
      "the resource_saturated anomaly (0 disables).")
_flag("BFTKV_SAT_SCRAPES", "3", "int",
      "Consecutive saturated scrapes before resource_saturated fires "
      "(one episode, one anomaly; a clean scrape re-arms).")
_flag("BFTKV_SAT_WAIT_REF", "0.25", "float",
      "Capacity plane: queue-wait p99 (seconds) that maps to "
      "saturation 1.0 for wait-derived resources (admission, "
      "dispatch; the log commit path uses max(4x linger, this)).")
_flag("BFTKV_REGION_LEASE_S", "0", "float",
      "Gateway freshness lease in seconds: while the last sync-"
      "invalidation round completed this recently, TTL-expired cache "
      "entries may still be served same-region (0 disables).")
_flag("BFTKV_WORKLOAD", None, "str",
      "Workload spec `preset[,k=v,...]` (workload/spec.py) for "
      "spec-shaped traffic: the chaos nemesis `--workload` default "
      "(unset: coverage traffic only).")
_flag("BFTKV_WORKLOAD_SEED", None, "int",
      "Seed override for workload-driven runs; one seed replays one op "
      "stream bit-for-bit (unset: the caller's default).")
_flag("BFTKV_WORKLOAD_RATE", None, "float",
      "Offered-load override in ops/s for workload-driven runs (unset: "
      "the caller's default).")
_flag("BFTKV_WORKLOAD_DURATION", None, "float",
      "Per-preset schedule duration override in seconds (unset: the "
      "caller's default).")
_flag("BFTKV_WORKLOAD_PROCS", None, "int",
      "Worker-process count of workload.driver.run_multiprocess (unset: 2).")


def _check(name: str) -> Flag:
    f = FLAGS.get(name)
    if f is None:
        raise KeyError(
            f"undeclared BFTKV flag {name!r}: declare it in "
            "bftkv_tpu_torch/flags.py before reading it"
        )
    return f


def declared() -> dict[str, Flag]:
    """Name → :class:`Flag` for every declared flag."""
    return dict(FLAGS)


def raw(name: str, default: str | None = None) -> str | None:
    """The raw environment value, or ``default`` when unset."""
    _check(name)
    v = os.environ.get(name)
    return default if v is None else v


def get(name: str) -> str | None:
    """Environment value, falling back to the registry default."""
    f = _check(name)
    v = os.environ.get(name)
    return f.default if v is None else v


def get_int(name: str, default: int | None = None) -> int | None:
    """Integer value; unset or empty falls back to ``default``, then to
    the registry default."""
    f = _check(name)
    v = os.environ.get(name)
    if v is None or v == "":
        if default is not None:
            return default
        return int(f.default) if f.default is not None else None
    return int(v)


def get_float(name: str, default: float | None = None) -> float | None:
    """Float value; unset or empty falls back to ``default``, then to
    the registry default."""
    f = _check(name)
    v = os.environ.get(name)
    if v is None or v == "":
        if default is not None:
            return default
        return float(f.default) if f.default is not None else None
    return float(v)


def enabled(name: str, default: str | None = None) -> bool:
    """Switch semantics of the reference: a set value is on unless it
    lowercases to ``off``/``0``/``false``; unset falls back to
    ``default``, then to the registry default (empty means off)."""
    f = _check(name)
    v = os.environ.get(name)
    if v is None:
        v = default if default is not None else (f.default or "")
        if v == "":
            return False
    return v.lower() not in ("off", "0", "false")
