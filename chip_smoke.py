"""Smoke run of the PyTorch/CUDA port on one GPU: the replica's crypto plane
and the protocol above it.

Drives the port's main paths at the size of the 64-replica cluster and
holds every hand-written kernel against its plain PyTorch version:

1. keys: 64 replica RSA-2048 keys, 4 writer and 8 storage-node keys, drawn
   from --seed (cached under bftkv_tpu_torch/_build/), and 64 + 4 P-256
   keys, with the signed verify items of both, outside every timed phase;
2. build: the kernels from bftkv_tpu_torch/ops/csrc/ for sm_90a;
3. RNS verify phase: 64 threads, one per replica, submit their share of
   one 4096-item flush to VerifyDispatcher(max_batch=4096): about 93
   writes x 44 verifies (writer signature + 43 collective entries), 1%
   forged by a bit flip, a few hostile moduli (sharing a channel prime), a
   few s >= n.  Verdicts must equal host pow(s, 65537, n) == em;
4. RNS sign phase: 64 threads sign 256 collective shares through
   SignDispatcher(max_batch=256): 512 half-width rows in one K2 launch,
   then the fault check (one K1 launch).  Every signature must equal host
   signing;
5. pallas verify phase: the same 4096 items through
   VerifierDomain(backend="pallas"): one K3 launch per flush, every item
   on the device (hostile moduli are odd and fit; s >= n rides as s = 0);
6. limb sign phase: 256 shares through SignerDomain(backend="limb"): one
   512-row limb power_batch (PyTorch ops) and one K1 fault check;
7. BatchModExp phase: (a) 64 pairs of 2048-bit bases and exponents modulo
   one replica modulus, K2 at k=188; (b) 8 pairs with
   2300-bit exponents, the shape of threshold-RSA fragments, on the limb
   path with the 256-limb exponent bucket.  Both must equal host pow;
8. dispatch-plane phase, at the reference's max_batch=1024:
   (a) 64 threads submit the 4096 verify items through VerifyDispatcher,
   several K1 launches (T=1024) a round, at pipeline 1 and 2 in turns;
   (b) the 256-share rns sign flush at pipeline 1 and 2;
   (c) one ModexpDispatcher flush of 64 2048-bit and 64 1024-bit items:
   both K2 launches (k=188, k=94) on the stream before the first wait;
   (d) no staging slot left in flight; (e) one rns verify flush split
   into encode, stage, H2D, K1, D2H and scatter by host clock and CUDA
   events.  Verdicts, signatures and modexps must equal the host's;
9. EC phase, the same cluster on P-256 identity keys: (a) one 4096-item EC
   verify flush (the 93 writes, 1% forged, r = 0, s = n, a short signature
   and an off-curve key that must fail closed): K5 at T=8192; (b) the same
   items through VerifyDispatcher(max_batch=1024): K5 at T=2048; (c) one
   flush of half RSA and half EC items: K1 and K5 in it; (d) 256 shares
   under one replica key through SignDispatcher: K5 at T=256, every
   signature checked by host verify, ec.sign_fault 0; (e) one limb-engine
   call at 8 points.  Verdicts and points must equal the host curve's; the
   limb engine is never reached on the rns path.  Then timed flushes, one
   EC verify flush split into encode, stage, H2D, K5, D2H, decode and
   finish, and K5 against its plain version on each recorded operand set;
10. sidecar phase, the deployment of bftkv_tpu_torch/cmd/verify_sidecar.py:
   the port's sidecar on a Unix socket on the card, started as its main()
   starts it (max_batch=4096, the dispatchers' own window, the default
   admission), and 8 tenant threads, each on its own SidecarChannel: (a)
   the 4096 RSA verify items, 512 a tenant, each batch mixed with 32 of 256
   EC items, which the tenant verifies on its own VerifierDomain on the
   card (K5); (b) 256 sign shares under 8 replica keys, REGISTER first; (c)
   128 MODEXP items, 64 at 2048 bits and 64 at 1024 bits.  Every answer
   equals the host's, no tenant falls back, is shed or sees ERR, the
   sidecar's flushes launch K1 and K2, more than one tenant's 512 items
   ride each K1 launch; then 3 timed rounds of verify and of sign (tenant
   round trips, the sidecar's flushes), the STATS frame's rings, and every
   K1 and K2 launch of the sidecar and every K5 launch of the tenants held
   against its plain version;
11. shard phase: torch.cuda.device_count(); entry.dryrun_multichip(2) (both
   shards on this card, on separate streams); the verify at T=4096 and the
   sign modexp at k=94 T=512 split over two shards of this card and, with
   two or more cards, over every card, bit-identical to the unsplit launch;
   every K1 and K2 launch of the phase held against its plain version;
12. quorum phase (the port of bftkv_tpu/graph.py, quorum/, regions/,
   storage/ and topology.py): (a) the universe of the 64-replica cluster
   (64 servers cross-signed into one clique, 8 storage-only rw nodes, the
   4 writers; 8 more seeded keys) built with topology.build_universe and a
   node made by make_node for each of the 76 principals, every server's
   AUTH and every writer's AUTH|PEER quorum the 64-clique at f=21, min=64,
   threshold=43, suff=43, WRITE adding the rw nodes; (b) the 93 writes
   certified as the protocol's client certifies them (43 servers' shares
   through Signer.issue_many, K2 k=94 and K1 fault checks; combined against
   each writer's quorum; verify_many per writer, K1); (c) 4096 candidate
   sets tallied on the card against the host predicates, and the
   equivocation tally at universe 256 with 85 colluders; (d) 72 durable
   LogStorages take the 93 packets, are reopened and read back, one
   replica re-verifies its stored signatures (K1), one store is compacted,
   a NativeStorage does the same; (e) the fill sweep (log and native to 1M
   keys, plain to 10k, a listed cut).  Every K1 and K2 launch of the phase
   is held against its plain version;
13. crypto-layer phase (the port of bftkv_tpu/crypto), on the same
   cluster: (a) the 93 writes' collective shares (the writer and 43
   replicas each) through Signer.issue_many with the dispatchers
   installed (K2 k=94, K1 fault checks), combined against each writer's
   quorum from the quorum phase, 1% of the entries forged, verify_many
   of each writer's jobs with the verify memo reset (K1), then again
   with the memo on, the verdicts held to a host recount (at least 43
   valid signers in the clique); (b) a TPA round at n=64, k=43 (K2
   k=188), and a wrong password refused by every server; (c) threshold
   DSA at n=64, k=22 on a 2048-bit p drawn from --seed (K2 k=188); (d)
   threshold ECDSA at n=64, k=22 (K5 at T=8 a partial R, and the
   combine); (e) threshold RSA (3, 4) at 2048 bits, whose fragments
   sign on the host: no launch; (f) a MessageSecurity bootstrap and
   session round trip between an RSA and a P-256 replica (ECIES), the
   native modexp and codec tiers.  Every verdict, signature and secret
   equals the host's; every K1, K2 and K5 launch of the phase is held
   against its plain version;
14. protocol phase (the port of bftkv_tpu/transport/, protocol/, sync/,
   crypto/presession.py and api.py), bench.py's bench_cluster_batch(64, 8,
   4, 1024, 2): (a) the quorum phase's universe as 64 port Servers and 8
   storage nodes on MemStorage over one LoopbackNet and 4 port Clients,
   every node on the card, VerifyDispatcher and SignDispatcher
   (max_batch=4096) installed; the fan-out must be threaded; a warm
   write_many of 64; (b) one storage node misses single writes' back-fill
   and a batched round (transport.send drop failpoint), runs its
   SyncDaemon's repair_once() and a pull round, and must then match the
   other storage nodes' digest root and serve every write; (c) the 4
   writers released together, write_many of 1024 items of 1 KiB then a
   read_many of every key, for 1 round (bench.py's 2 rounds cut to 1 for
   the deploy phase's time; the batch is cut to a 75 s budget and the cut
   printed); every acknowledged write reads
   back; signed writes/s, reads/s, the write_many phase timers, the
   server handlers, K1/K2 launches and rows, the memo's hits; (d)
   revoke-on-read on a response map of 512 signers with 170 colluders:
   one equivocation_pairs launch whose mask equals the host scan, exactly
   the colluders revoked; (e) 4 + 4 servers on TrHTTP at probed localhost
   ports and api.open_client(device=) on a port home: a write, read,
   write_many and read_many read back.  Every K1 and K2 launch of (c) is
   held against its plain version;
15. deploy phase (the port of bftkv_tpu/cmd/, gateway/, workload/,
   obs/source.py, obs/profiler.py): the same round as the deployment runs
   it, one process per replica: (a) the 64 + 8 + 4 universe and a gateway
   at probed localhost ports, homes written by genkeys.write_homes, the
   port's sidecar served in this process on the card (admission sized for
   72 tenants), 72 daemons (python -m bftkv_tpu_torch.cmd.bftkv --device
   cuda:0) spawned by run_cluster.spawn(sidecar=...); spawn time and the
   fleet's resident memory; (b) 4 bftrw processes released together, each
   writemany of 1024 items of 1 KiB, then readmany of every key (the batch
   cut to a 180 s budget, printed); every acknowledged write reads back; no
   daemon falls back to local crypto or holds a context on the card, the
   sidecar sheds nothing; (c) run_gateway --sidecar in front of the fleet,
   64 keys read twice through a GatewayClient, the second pass from its
   certified cache; (d) workload.driver.run_multiprocess, write_heavy, 2
   worker processes at 120 ops/s for 10 s (a probe sizes a printed cut),
   no error; (f) the fleet health plane (obs/, cmd/fleet.py): the daemons
   spawned with run_cluster's --fleet and --recorder, 8 writes through a
   daemon's client API, then /fleet must list all 72 members up, every
   f-budget full and those writes in its write SLO; a demand bundle; the
   collector process never maps libcuda; cmd.fleet one-shot over the 72
   APIs exits 0 without importing torch; a collector in this process times
   its scrapes of the 72 and sees the sidecar's stats as a role=sidecar
   member with its dispatch occupancy; (e) run_cluster.shutdown, every
   daemon exits 0.  Every K1 and K2 launch of the sidecar in (b) is held
   against its plain version;
16. chaos phase (the port of bftkv_tpu/faults/), each run a process of its
   own with its launches counted and kept, host thresholds 0 and the verify
   memo off (one process shares one memo): (a) python
   -m bftkv_tpu_torch.faults.nemesis --seed 7 --bits 2048 --device cuda:0,
   the 4 + 1 + 4 chaos cluster on the card; (b) the sidecar chaos form,
   --steps 12 --sidecar --kinds sidecar_crash,partition,crash_restart,
   link_delay,sidecar_crash with the flight recorder armed.  Both exit 0
   (zero safety violations, every fault window in the health feed, no
   write lost to a sidecar crash, one bundle per window); every K1 and K2
   launch of the phase is held against its plain version;
17. each kernel against its plain version on the card, on the operands the
   main paths gave it: K1 verdicts (T=4096, T=1024 and every fault check's
   T=256), K2 sigma (k=94 at T=512 and T=64, k=188), K3's whole
   (4096, 128) diff and K5's Jacobian residues bit-identical;
18. times: median of 5 timed flushes per verify/RNS-sign phase, 3 for the
   limb sign and the EC flushes, and kernel times by CUDA events, beside
   nvidia-smi's name and power limit.

Every path runs with the dispatch plane's defaults (pipeline 2 on the
card, async launches, staging rings).  Every phase sets the launch counts
and counters to 0 just before its counted run and reads them just after.

Run from the repository root:  python3 chip_smoke.py [--seed N]
It exits non-zero, printing no result, without CUDA or on any failed check.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import multiprocessing
import os
import random
import signal
import statistics
import subprocess
import sys
import threading
import time

import torch

N_REPLICAS = 64
N_WRITERS = 4
N_WRITES = 93
SUFF = 43  # collective entries per write at n=64, f=21
VERIFY_FLUSH = 4096
SIGN_SHARES = 256
TIMED_REPS = 5
LIMB_SIGN_REPS = 3
MODEXP_PAIRS = 64  # 2048-bit pairs: K2 at k=188
PLANE_MAX_BATCH = 1024  # the reference dispatchers' default
PLANE_ROUNDS = 5  # rounds of each plane run, pipeline 1 and 2 in turns
SPLIT_REPS = 5
FRAGMENT_PAIRS = 8  # 2300-bit exponents: the limb path
FRAGMENT_EXP_BITS = 2300

# Card peaks (NVIDIA H100 SXM data sheet, dense): int8 tensor cores and HBM3.
INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12
# An exact product of two 12-bit residues (K1, K2) takes three int8 products
# on the tensor cores: 6-bit planes lo, hi and Karatsuba's (lo+hi)*(lo+hi),
# whose byte sums stay below 127: 6 ops per MAC.  A digit -> residue
# conversion MAC, an 8-bit digit half times a 12-bit entry of D, takes two
# (D in two planes): 4 ops.  K3's 16-bit digit products take four 8-bit
# products: 8 ops per MAC.
RNS_OPS_PER_MAC = 6
CONV_OPS_PER_MAC = 4
MONT_OPS_PER_MAC = 8
# The parent's K2 (CUDA cores, rns_chain.cu, 2 rows per block) at the main
# path's two shapes, as PERF.md records them (not measured by this script).
K2_EARLIER_MS = {94: 3.6543, 188: 10.935}
K2_EARLIER_OF = "PERF.md section 6, the CUDA-core kernel it replaced, H100 80GB HBM3, 700 W"
# The same for K1 at the verify flush's shape.
K1_EARLIER_MS = {VERIFY_FLUSH: 1.3068}
K1_EARLIER_OF = "PERF.md section 6, the CUDA-core kernel it replaced, H100 80GB HBM3, 700 W"
# The same for K3 at the pallas flush's shape.
K3_EARLIER_MS = {VERIFY_FLUSH: 1.0182}
K3_EARLIER_OF = "PERF.md section 6, the one-thread-per-row kernel it replaced, H100 80GB HBM3, 700 W"
# K3's second figure: its 32-bit word multiply-adds (19 products of 2 * 64^2
# a row) on the CUDA cores, issued at 64 or at 32 a clock per SM (IMAD.WIDE
# at the full integer rate or at half of it), at the card's top SM clock.
MONT_WORD_MACS_PER_ROW = 19 * 2 * 64 * 64
IMAD_PER_CLOCK_PER_SM = (64, 32)
# The EC phase: P-256 identity keys on the same cluster.
EC_SIGN_SHARES = 256  # under one replica key: K5 at T=256
EC_TIMED_REPS = 3
EC_LIMB_POINTS = 8
# RNS Montgomery products of one P-256 scalar mult, counted from
# ops/ec_rns.py::_scalar_mult: 14 table adds of 24 (16 of the add, 8 of the
# doubling it also evaluates), then 64 windows of 4 doublings (8 each) and one add.
EC_PRODUCTS = 14 * 24 + 64 * (4 * 8 + 24)
# K5's base extensions run on the int8 tensor cores; its elementwise floor is
# the integer multiplies of the Barrett and Shoup steps of each product, counted
# from rns_mma.cuh's Chain::mont per (channel, point) pair: 4 Barrett steps (2
# IMAD: umulhi, multiply-subtract), 6 Shoup steps (3: the product, umulhi,
# multiply-subtract) and the 2 residue products, at each of the 32 channel rows
# (2 M tiles of 16) a point holds, issued at 64 IMAD a clock per SM.
EC_IMAD_PER_PAIR = 4 * 2 + 6 * 3 + 2
EC_ROWS_PER_POINT = 32
# The sidecar phase: the documented deployment, replicas sharing one card.
SIDECAR_TENANTS = 8
SIDECAR_EC_ITEMS = 256  # mixed into the tenants' verify batches, verified in the tenants
SIDECAR_MODEXP = 128  # 64 at 2048 bits, 64 at 1024 bits
SIDECAR_ROUNDS = 3  # timed rounds of verify and of sign
# The crypto-layer phase, on the same 64-replica cluster (n=64, f=21):
# collective signatures checked against suff, TPA at the auth threshold
# 2f+1, threshold DSA/ECDSA at the cert threshold f+1, threshold RSA (3, 4).
AUTH_K = 43  # 2f + 1
CERT_K = 22  # f + 1
TRSA_N, TRSA_K = 4, 3
CRYPTO_WORKERS = 8  # threads serving the threshold servers' host work
NATIVE_SIGNS = 256
# The quorum phase: the headline cluster's universe (64 servers cross-signed
# into one clique, 8 storage-only rw nodes, the 4 writers as users), its
# web-of-trust quorums, the tallies and the replicas' stores.
N_STORAGE = 8
TALLY_SETS = 4096  # candidate sets tallied on the card against the host predicates
TALLY_SIZES = (20, 64)  # sizes of the seeded random ack sets, around the thresholds
TALLY_REPS = 20
EQUIV_UNIVERSE, EQUIV_BYZ, EQUIV_PAIRS = 256, 85, 4096  # BASELINE config 5 (bench.py bench_tally)
FILL_POINTS = (10_000, 100_000, 1_000_000)  # resident keys (bench.py _fill_sweep)
FILL_PROBES = 2000  # timed probe writes at each point
FILL_READBACK = 10_000  # seeded keys read back at the last point
PLAIN_FILL_CAP = 10_000  # PlainStorage writes one file per version: filled to its first point only
# Rows of one plain run when launches are held against their plain versions
# (the protocol phase's rounds make over a million K1 rows).
HOLD_ROWS = 65536
# The protocol phase: the headline's deployment, bench.py:1661
# bench_cluster_batch(64, 8, 4, 1024, 2) (bench.py:3106), the 64 servers, 8
# storage nodes and 4 writers of the quorum phase's universe as port servers
# and clients on one loopback net.
PROTO_BATCH = 1024  # items per write_many round
PROTO_ROUNDS = 1  # cut from bench.py's 2: the deploy phase runs the same round as processes
PROTO_VALUE_BYTES = 1024
PROTO_WARM = 64
PROTO_DISPATCH_BATCH = 4096  # bench.py:1689-1692
PROTO_BUDGET_S = 75.0  # the counted rounds: rounds are cut first, then the batch (cut from 150 s for the chaos phase's time)
PROTO_MISSED = 64  # anti-entropy: a batched round one storage node misses
PROTO_MISSED_SINGLE = 3  # and single writes whose back-fill it misses
# The deploy phase: the same round as the deployment runs it, one process
# per replica (cmd/run_cluster.py), every daemon and the gateway signing and
# verifying through one crypto sidecar on the card, served in this process.
DEPLOY_BATCH = 1024  # items per writer's writemany
DEPLOY_WARM = 128  # warm writemany per writer, whose time sizes the batch cut
DEPLOY_BUDGET_S = 180.0  # the counted round: the batch is cut to fit
DEPLOY_GW_READS = 64
DEPLOY_WL_RATE, DEPLOY_WL_DURATION_S, DEPLOY_WL_PROCS = 120.0, 10.0, 2  # bench.py:2015's rate
DEPLOY_WL_PROBE_OPS = 8  # ops a worker in the probe run that sizes the workload cut
DEPLOY_WL_BUDGET_S = 45.0
DEPLOY_RPC_TIMEOUT_S = 600.0  # a BATCH_WRITE of 256 items verifies ~11k entries via the sidecar
# The sidecar's admission for 72 daemons and a gateway (its defaults, 4
# batches in service and 64 waiting 0.5 s, are for a handful of tenants); a
# batch waits less than its tenant's 30 s channel timeout.
DEPLOY_ADMISSION = {"max_inflight": 256, "max_queue": 1024, "max_wait": 20.0}
DEPLOY_START_S = 300.0  # every daemon's ports up
DEPLOY_STOP_S = 120.0  # every daemon's exit after SIGTERM
DEPLOY_FLEET_INTERVAL_S = 2.0  # the collector's scrape interval (run_cluster's default)
DEPLOY_FLEET_WRITES = 8  # writes through a daemon's client API after the round: its write latency keys
DEPLOY_FLEET_WAIT_S = 120.0  # until /fleet shows every member up and those writes in its write SLO
DEPLOY_FLEET_SCRAPES = 3  # timed scrapes of the 72 daemon APIs by a collector in this process

# The chaos phase (the port of bftkv_tpu/faults/ and the rest of bftkv_tpu/obs/):
# the roadmap's `nemesis --seed 7`, then the documented sidecar chaos form.
CHAOS_SEED = 7
CHAOS_BITS = 2048
CHAOS_SIDECAR_STEPS = 12
CHAOS_SIDECAR_KINDS = "sidecar_crash,partition,crash_restart,link_delay,sidecar_crash"
CHAOS_RUN_TIMEOUT_S = 600.0

# Revoke-on-read: BASELINE config 5's shape (256 replicas, 85 colluders) puts
# 341 signer entries in the read's rows, under the client's
# BATCH_REVOKE_THRESHOLD of 512, so the case doubles it.
REVOKE_UNIVERSE, REVOKE_BYZ = 512, 170
HTTP_SERVERS, HTTP_STORAGE, HTTP_ITEMS = 4, 4, 16  # bench.py's cluster_4_http shape


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# -- keys and signed items (host, in worker processes) ------------------------


def _gen_key(seed: int):
    from bftkv_tpu_torch.crypto import rsa

    k = rsa.generate(2048, seed=seed)
    return (k.n, k.e, k.d, k.p, k.q)


def _sign_many(job):
    from bftkv_tpu_torch.crypto import rsa

    (n, e, d, p, q), msgs = job
    key = rsa.PrivateKey(n=n, e=e, d=d, p=p, q=q)
    return [rsa.sign(m, key) for m in msgs]


def load_keys(pool, seed: int, build_dir: str):
    from bftkv_tpu_torch.crypto import rsa

    path = os.path.join(build_dir, f"smoke_keys_seed{seed}.json")
    seeds = [seed * 1000 + i for i in range(N_REPLICAS + N_WRITERS + N_STORAGE)]
    tuples = None
    if os.path.exists(path):
        with open(path) as f:
            cached = json.load(f)
        if cached.get("seeds") == seeds:
            tuples = [tuple(int(x, 16) for x in t) for t in cached["keys"]]
    if tuples is None:
        tuples = pool.map(_gen_key, seeds)
        os.makedirs(build_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump({"seeds": seeds, "keys": [[hex(x) for x in t] for t in tuples]}, f)
    keys = [rsa.PrivateKey(n=n, e=e, d=d, p=p, q=q) for n, e, d, p, q in tuples]
    for k in keys:
        check(k.n == k.p * k.q and k.n.bit_length() == 2048, "bad cached key")
    return (keys[:N_REPLICAS], keys[N_REPLICAS:N_REPLICAS + N_WRITERS],
            keys[N_REPLICAS + N_WRITERS:])


def verify_items(pool, replicas, writers, seed: int):
    """4096 (message, sig, PublicKey) items of 93 writes, plus the host's
    expected verdicts."""
    from bftkv_tpu_torch.crypto import rsa
    from bftkv_tpu_torch.ops import rns

    rng = random.Random(seed)
    plan = []  # (key, message)
    for w in range(N_WRITES):
        tbs = b"write-%d-seed-%d" % (w, seed)
        plan.append((writers[w % N_WRITERS], tbs))
        for j in range(SUFF):
            plan.append((replicas[(7 * w + j) % N_REPLICAS], tbs))
    while len(plan) < VERIFY_FLUSH:
        plan.append((writers[len(plan) % N_WRITERS], b"extra-%d" % len(plan)))
    by_key: dict[int, list[int]] = {}
    keyobj = {}
    for i, (k, _m) in enumerate(plan):
        by_key.setdefault(k.n, []).append(i)
        keyobj[k.n] = k
    jobs = [
        ((keyobj[n].n, keyobj[n].e, keyobj[n].d, keyobj[n].p, keyobj[n].q),
         [plan[i][1] for i in idxs])
        for n, idxs in by_key.items()
    ]
    sigs = [None] * len(plan)
    for (n, idxs), out in zip(by_key.items(), pool.map(_sign_many, jobs)):
        for i, s in zip(idxs, out):
            sigs[i] = s
    items = [(m, s, k.public) for (k, m), s in zip(plan, sigs)]
    picks = rng.sample(range(len(items)), len(items) // 100 + 6)
    forged, hostile, big = picks[:-6], picks[-6:-3], picks[-3:]
    for i in forged:
        m, s, pub = items[i]
        items[i] = (m, s[:-1] + bytes([s[-1] ^ 1]), pub)
    pb = rns.context().pb
    for j, i in enumerate(hostile):
        m, s, _pub = items[i]
        n = pb[j] * (rng.getrandbits(2036) | (1 << 2035) | 1)  # shares channel prime
        items[i] = (m, s, rsa.PublicKey(n=n))
    for i in big:
        m, _s, pub = items[i]
        s = pub.n + rng.randrange((1 << 2048) - pub.n)
        items[i] = (m, s.to_bytes(256, "big"), pub)
    expect = []
    for m, s, pub in items:
        sv = int.from_bytes(s, "big")
        em = rsa.emsa_pkcs1v15_sha256(m, pub.size_bytes)
        expect.append(sv < pub.n and pow(sv, pub.e, pub.n) == em)
    rns_capable = sum(
        1 for m, s, pub in items
        if rns.context().key_rows(pub.n) is not None and int.from_bytes(s, "big") < pub.n
    )
    return items, expect, rns_capable, len(forged), len(hostile), len(big)


def ec_keys(seed: int):
    """64 replica and 4 writer P-256 keys drawn from ``seed``."""
    from bftkv_tpu_torch.crypto import ecdsa

    keys = [ecdsa.generate(seed=seed * 1000 + 500 + i) for i in range(N_REPLICAS + N_WRITERS)]
    return keys[:N_REPLICAS], keys[N_REPLICAS:]


def _ec_sign_many(job):
    from bftkv_tpu_torch.crypto import ec, ecdsa

    d, msgs = job
    x, y = ec.P256.scalar_base_mult(d)
    key = ecdsa.ECPrivateKey(d=d, public=ecdsa.ECPublicKey(x=x, y=y))
    return [ecdsa.sign(m, key) for m in msgs]


def _ec_verify_many(chunk):
    from bftkv_tpu_torch.crypto import ecdsa

    return [ecdsa.verify_host(m, s, ecdsa.ECPublicKey(x=x, y=y)) for m, s, x, y in chunk]


def ec_verify_items(pool, replicas, writers, seed: int):
    """4096 EC (message, sig, ECPublicKey) items of 93 writes, 1% forged,
    and four that must fail closed (r = 0, s = n, a short signature, an
    off-curve key); plus the host curve's verdicts."""
    from bftkv_tpu_torch.crypto import ec, ecdsa

    rng = random.Random(seed + 1)
    plan = []
    for w in range(N_WRITES):
        tbs = b"ec-write-%d-seed-%d" % (w, seed)
        plan.append((writers[w % N_WRITERS], tbs))
        for j in range(SUFF):
            plan.append((replicas[(7 * w + j) % N_REPLICAS], tbs))
    while len(plan) < VERIFY_FLUSH:
        plan.append((writers[len(plan) % N_WRITERS], b"ec-extra-%d" % len(plan)))
    by_key: dict[int, list[int]] = {}
    for i, (k, _m) in enumerate(plan):
        by_key.setdefault(k.d, []).append(i)
    sigs = [None] * len(plan)
    jobs = [(d, [plan[i][1] for i in idxs]) for d, idxs in by_key.items()]
    for idxs, out in zip(by_key.values(), pool.map(_ec_sign_many, jobs)):
        for i, sg in zip(idxs, out):
            sigs[i] = sg
    items = [(m, sg, k.public) for (k, m), sg in zip(plan, sigs)]
    picks = rng.sample(range(len(items)), len(items) // 100 + 4)
    forged, bad = picks[:-4], picks[-4:]
    for i in forged:
        m, sg, pub = items[i]
        items[i] = (m, sg[:-1] + bytes([sg[-1] ^ 1]), pub)
    n = ec.P256.n
    m, sg, pub = items[bad[0]]
    items[bad[0]] = (m, bytes(32) + sg[32:], pub)  # r = 0
    m, sg, pub = items[bad[1]]
    items[bad[1]] = (m, sg[:32] + n.to_bytes(32, "big"), pub)  # s = n
    m, sg, pub = items[bad[2]]
    items[bad[2]] = (m, sg[:-1], pub)  # short
    m, sg, pub = items[bad[3]]
    items[bad[3]] = (m, sg, ecdsa.ECPublicKey(x=pub.x, y=(pub.y + 1) % ec.P256.p))  # off-curve
    chunks = [[(m, sg, k.x, k.y) for m, sg, k in items[i : i + 256]]
              for i in range(0, len(items), 256)]
    expect = [v for out in pool.map(_ec_verify_many, chunks) for v in out]
    return items, expect, len(forged), len(bad)


# -- phases ---------------------------------------------------------------------


def run_threads(n: int, target) -> float:
    """Runs target(t) on n threads released together; returns wall seconds."""
    barrier = threading.Barrier(n + 1)
    errors = []

    def body(t):
        barrier.wait()
        try:
            target(t)
        except BaseException as e:  # reported below; the phase fails
            errors.append(e)

    threads = [threading.Thread(target=body, args=(t,)) for t in range(n)]
    for th in threads:
        th.start()
    barrier.wait()
    t0 = time.perf_counter()
    for th in threads:
        th.join(timeout=600)
    dt = time.perf_counter() - t0
    check(not any(th.is_alive() for th in threads), "a submitter thread hung")
    if errors:
        raise errors[0]
    return dt


def verify_phase(vd, items):
    share = len(items) // N_REPLICAS
    results = [None] * N_REPLICAS

    def submit(t):
        results[t] = vd.verify(items[t * share : (t + 1) * share])

    dt = run_threads(N_REPLICAS, submit)
    return [bool(v) for r in results for v in r], dt


def sign_phase(sd, replicas, tag: str):
    per = SIGN_SHARES // N_REPLICAS
    jobs = [
        [(b"share-%s-%d-%d" % (tag.encode(), t, j), replicas[t]) for j in range(per)]
        for t in range(N_REPLICAS)
    ]
    results = [None] * N_REPLICAS

    def submit(t):
        results[t] = sd.submit(jobs[t])

    dt = run_threads(N_REPLICAS, submit)
    return [it for j in jobs for it in j], [s for r in results for s in r], dt


def check_signatures(sign_items, sigs, what: str) -> None:
    from bftkv_tpu_torch.crypto import rsa

    for (m, key), sig in zip(sign_items, sigs):
        check(rsa.verify_host(m, sig, key.public), f"{what}: a signature fails host verify")
        check(sig == rsa.sign(m, key), f"{what}: a signature differs from host signing")


class Recorder:
    """Keeps the operands the main path hands the kernel wrappers
    ``names`` of ``module`` (copies, or with ``copy=False`` the tensors
    themselves, enough to count launches by shape)."""

    def __init__(self, module, names, copy: bool = True):
        self.mod = module
        self.copy = copy
        self.real = {name: getattr(module, name) for name in names}
        self.calls = {name: [] for name in names}

    def __enter__(self):
        for name, fn in self.real.items():
            setattr(self.mod, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def rec(*args):
            # Copies, on the launch's stream: the staging slots the
            # operands live in are reused by later launches.
            self.calls[name].append(_clone(args) if self.copy else args)
            return fn(*args)

        return rec

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.mod, name, fn)


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return tuple(_clone(a) for a in x)
    return x


class Counted:
    """A phase's counted run: launch counts and counters are set to 0 on
    entry and read on exit (``launches``, ``snap``)."""

    def __enter__(self):
        from bftkv_tpu_torch.metrics import registry as metrics
        from bftkv_tpu_torch.ops import cuda_ec, cuda_mont, cuda_rns

        metrics.reset()
        cuda_rns.reset_launches()
        cuda_mont.reset_launches()
        cuda_ec.reset_launches()
        return self

    def __exit__(self, *exc):
        from bftkv_tpu_torch.metrics import registry as metrics
        from bftkv_tpu_torch.ops import cuda_ec, cuda_mont, cuda_rns

        self.launches = {**cuda_rns.LAUNCHES, **cuda_mont.LAUNCHES, **cuda_ec.LAUNCHES}
        self.snap = metrics.snapshot()
        # The flush workers' streams are done before anything they made
        # (recorded operands) is read on another stream.
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()


# -- the dispatch-plane phase ------------------------------------------------------


class FlushClock:
    """Host clock around each flush's batch call on its worker (encode,
    staging, copies, kernel, copy out, verdicts into the batch's array)."""

    def __init__(self, d):
        self.d, self.real, self.seconds = d, d._run_batch, []

    def __enter__(self):
        def timed(items):
            t0 = time.perf_counter()
            try:
                return self.real(items)
            finally:
                self.seconds.append(time.perf_counter() - t0)

        self.d._run_batch = timed
        return self

    def __exit__(self, *exc):
        self.d._run_batch = self.real


def plane_verify(vds, items, expect):
    """(a) rounds of the 4096 items through VerifyDispatcher(max_batch=1024)
    at pipeline 1 and 2 in turns; returns per-pipeline results and the
    first round's recorded K1 operands."""
    from bftkv_tpu_torch.ops import cuda_rns

    res = {pl: {"round_s": [], "flush_s": [], "k1_launches": 0, "flushes": 0,
                "k1_by_rows": {}} for pl in vds}
    rec_args = []
    for r in range(PLANE_ROUNDS):
        for pl in (1, 2) if r % 2 == 0 else (2, 1):
            keep = r == 0 and pl == 2
            with Recorder(cuda_rns, ("verify_cuda",), copy=keep) as rec, \
                    FlushClock(vds[pl]) as fc, Counted() as c:
                got, dt = verify_phase(vds[pl], items)
            check(got == expect, f"plane verify (pipeline {pl}): verdicts differ from host pow")
            flushes = c.snap.get("dispatch.flushes", 0)
            check(c.launches["verify"] == flushes >= 2,
                  f"plane verify (pipeline {pl}): K1 launches {c.launches} for {flushes} flushes")
            check(c.launches["pow"] == 0 and c.launches["mont_verify"] == 0,
                  f"plane verify launched {c.launches}")
            if keep:
                rec_args = [a for a in rec.calls["verify_cuda"] if a[0].shape[0] == PLANE_MAX_BATCH]
            by_rows = res[pl]["k1_by_rows"]
            for a in rec.calls["verify_cuda"]:
                by_rows[a[0].shape[0]] = by_rows.get(a[0].shape[0], 0) + 1
            res[pl]["round_s"].append(dt)
            res[pl]["flush_s"] += fc.seconds
            res[pl]["k1_launches"] += c.launches["verify"]
            res[pl]["flushes"] += flushes
    return res, rec_args


def plane_sign(sds, replicas):
    """(b) the 256-share rns sign flush at pipeline 1 and 2 in turns."""
    res = {pl: {"round_s": [], "k2_launches": 0, "k1_launches": 0} for pl in sds}
    for r in range(PLANE_ROUNDS):
        for pl in (1, 2) if r % 2 == 0 else (2, 1):
            with Counted() as c:
                sign_items, sigs, dt = sign_phase(sds[pl], replicas, f"plane{pl}-{r}")
            check_signatures(sign_items, sigs, f"plane sign (pipeline {pl})")
            check(c.snap.get("sign.device", 0) == SIGN_SHARES and c.launches["pow"] >= 1,
                  f"plane sign (pipeline {pl}): sign.device {c.snap.get('sign.device')}, "
                  f"launches {c.launches}")
            res[pl]["round_s"].append(dt)
            res[pl]["k2_launches"] += c.launches["pow"]
            res[pl]["k1_launches"] += c.launches["verify"]
    return res


def plane_modexp(dev, replicas, seed: int):
    """(c) one ModexpDispatcher flush of mixed 2048-bit (k=188) and
    1024-bit (k=94) moduli: both K2 launches on the stream before the
    first wait."""
    from bftkv_tpu_torch.ops import cuda_rns, dispatch, rns

    rng = random.Random(seed + 7)
    items = [(rng.getrandbits(2048), rng.getrandbits(2048), k.n) for k in replicas]
    items += [(rng.getrandbits(1024), rng.getrandbits(1024), k.p) for k in replicas]
    deferred, first_wait = [], []
    real_pmr, real_wait = rns.power_mod_rns, rns.DeferredModexp.wait

    def pmr(*a, **kw):
        out = real_pmr(*a, **kw)
        if kw.get("defer"):
            deferred.append(out)
        return out

    def wait(self):
        if not first_wait:
            first_wait.append(dict(cuda_rns.LAUNCHES))
        return real_wait(self)

    md = dispatch.ModexpDispatcher(device=dev, device_threshold=2, calibrate=False,
                                   max_batch=PLANE_MAX_BATCH, max_wait=0.05).start()
    rns.power_mod_rns, rns.DeferredModexp.wait = pmr, wait
    try:
        with Recorder(cuda_rns, ("pow_cuda",)) as rec, Counted() as c:
            t0 = time.perf_counter()
            got = md.submit(items)
            dt = time.perf_counter() - t0
    finally:
        rns.power_mod_rns, rns.DeferredModexp.wait = real_pmr, real_wait
        md.stop()
    check(got == [pow(b, e, m) for b, e, m in items], "ModexpDispatcher results != host pow")
    check(c.launches["pow"] == 2, f"ModexpDispatcher flush launched {c.launches}")
    check(len(first_wait) == 1 and first_wait[0]["pow"] == 2,
          f"K2 launches at the first wait: {first_wait}")
    check(c.snap.get("modexp.device", 0) == len(items) and "modexp.host" not in c.snap,
          f"modexp.device {c.snap.get('modexp.device')} modexp.host {c.snap.get('modexp.host')}")
    ks = [a[4].k for a in rec.calls["pow_cuda"]]
    check(ks == [188, 94], f"K2 launch order by k: {ks}")
    check(len(deferred) == 2 and all(d.event is not None for d in deferred),
          "expected two deferred launches with events")
    # The k=94 launch's copy out completed after the k=188 one's: one
    # stream, in launch order.
    gap_ms = deferred[0].event.elapsed_time(deferred[1].event)
    check(gap_ms >= 0, f"the second group's event precedes the first's ({gap_ms} ms)")
    return {"flush_ms": dt * 1e3, "k2_launches": c.launches["pow"],
            "k2_launches_at_first_wait": first_wait[0]["pow"], "launch_order_k": ks,
            "event_gap_ms": gap_ms}, rec.calls["pow_cuda"]


def split_verify_flush(vd, items):
    """(e) one rns verify flush through a pipeline-1 VerifyDispatcher (one
    submitter), split into encode, stage, H2D, K1, D2H and scatter: host
    clock at the phase boundaries, CUDA events around the copies and the
    kernel on the flush's stream."""
    from bftkv_tpu_torch.ops import cuda_rns, devbuf, rns

    marks: dict = {}
    ev = lambda: torch.cuda.Event(enable_timing=True)
    real = {
        "entry": rns.verify_e65537_rns_indexed, "k1": cuda_rns.verify_cuda,
        "upload": devbuf.Slot.upload, "download": devbuf.Slot.download,
        "batch": vd.verifier.verify_batch,
    }

    def timed_events(key, fn):
        def run(*a, **kw):
            e0 = ev()
            e0.record()
            out = fn(*a, **kw)
            e1 = ev()
            e1.record()
            marks[key] = (e0, e1)
            return out
        return run

    def batch(items_):
        marks["start"] = time.perf_counter()
        out = real["batch"](items_)
        marks["batch_end"] = time.perf_counter()
        return out

    def entry(*a, **kw):
        marks["entry"] = time.perf_counter()
        out = real["entry"](*a, **kw)
        marks["exit"] = time.perf_counter()
        return out

    def upload(self, names):
        marks["upload"] = time.perf_counter()
        return timed_events("h2d", real["upload"])(self, names)

    rows = []
    rns.verify_e65537_rns_indexed, cuda_rns.verify_cuda = entry, timed_events("k1", real["k1"])
    devbuf.Slot.upload = upload
    devbuf.Slot.download = timed_events("d2h", real["download"])
    vd.verifier.verify_batch = batch
    try:
        for _ in range(SPLIT_REPS):
            marks.clear()
            got = vd.verify(items)
            done = time.perf_counter()
            check(len(got) == len(items), "split flush: wrong verdict count")
            torch.cuda.synchronize()
            rows.append({
                "encode_ms": (marks["entry"] - marks["start"]) * 1e3,
                "stage_ms": (marks["upload"] - marks["entry"]) * 1e3,
                "device_host_ms": (marks["exit"] - marks["upload"]) * 1e3,
                "h2d_ms": marks["h2d"][0].elapsed_time(marks["h2d"][1]),
                "k1_ms": marks["k1"][0].elapsed_time(marks["k1"][1]),
                "d2h_ms": marks["d2h"][0].elapsed_time(marks["d2h"][1]),
                "scatter_ms": (done - marks["exit"]) * 1e3,
                "flush_ms": (done - marks["start"]) * 1e3,
            })
    finally:
        rns.verify_e65537_rns_indexed, cuda_rns.verify_cuda = real["entry"], real["k1"]
        devbuf.Slot.upload, devbuf.Slot.download = real["upload"], real["download"]
        del vd.verifier.verify_batch
    return {key: statistics.median(r[key] for r in rows) for key in rows[0]}


# -- the EC phase ----------------------------------------------------------------


def ec_sign_phase(sd, key, tag: str):
    """64 threads submit 4 collective shares each under one replica key: one
    flush, one key group, one ecdsa.sign_batch (K5 at T=256)."""
    per = EC_SIGN_SHARES // N_REPLICAS
    jobs = [[(b"ec-share-%s-%d-%d" % (tag.encode(), t, j), key) for j in range(per)]
            for t in range(N_REPLICAS)]
    results = [None] * N_REPLICAS

    def submit(t):
        results[t] = sd.submit(jobs[t])

    dt = run_threads(N_REPLICAS, submit)
    return [it for j in jobs for it in j], [sg for r in results for sg in r], dt


def check_ec_signatures(sign_items, sigs, what: str) -> None:
    from bftkv_tpu_torch.crypto import ecdsa

    for (m, key), sg in zip(sign_items, sigs):
        check(ecdsa.verify_host(m, sg, key.public), f"{what}: a signature fails host verify")


def split_ec_verify_flush(vd, items):
    """One EC verify flush through a pipeline-1 VerifyDispatcher (one
    submitter), split into encode (signature parsing, SHA-256, s^-1 mod n,
    u1/u2), stage (residues and nibbles into the slot), H2D, K5, strip
    (the Montgomery strip and σ on the card), D2H of σ, decode (the three
    CRT rebuilds ``rns._sigma_to_ints``, then per point a ``pow`` inverse
    of Z and the affine products) and finish (u1·G + u2·Q, r compare,
    scatter): host clock at the boundaries, CUDA events around the copies
    and the kernel.  Then, on the last flush's Z values, the per-point
    ``pow`` inverses alone against one batch inversion (Montgomery's trick:
    one ``pow`` and 3(n − 1) products), what batching would save."""
    from bftkv_tpu_torch.crypto.ec import P256
    from bftkv_tpu_torch.ops import cuda_ec, devbuf, ec_rns, rns

    marks: dict = {}
    ev = lambda: torch.cuda.Event(enable_timing=True)
    real = {
        "entry": ec_rns.scalar_mult_hosts, "k5": cuda_ec.scalar_mult_cuda,
        "upload": devbuf.Slot.upload, "download": devbuf.Slot.download,
        "strip": ec_rns._P256RNS.strip_sigma, "decode": ec_rns._P256RNS.decode_sigma,
        "batch": vd.verifier.verify_batch,
    }

    def timed_events(key, fn):
        def run(*a, **kw):
            e0 = ev()
            e0.record()
            out = fn(*a, **kw)
            e1 = ev()
            e1.record()
            marks[key] = (e0, e1)
            return out
        return run

    def host_marks(first, last, fn):
        def run(*a, **kw):
            marks[first] = time.perf_counter()
            out = fn(*a, **kw)
            marks[last] = time.perf_counter()
            return out
        return run

    def upload(self, names):
        marks["upload"] = time.perf_counter()
        return timed_events("h2d", real["upload"])(self, names)

    def crt(*a, **kw):
        t0 = time.perf_counter()
        out = real["crt"](*a, **kw)
        marks["crt"] = marks.get("crt", 0.0) + time.perf_counter() - t0
        return out

    def decode(self, sigma):
        marks["sigma"] = (self.ctx, sigma)
        return host_marks("decode0", "decode1", real["decode"])(self, sigma)

    real["crt"] = rns._sigma_to_ints
    rows = []
    ec_rns.scalar_mult_hosts = host_marks("entry", "exit", real["entry"])
    cuda_ec.scalar_mult_cuda = timed_events("k5", real["k5"])
    devbuf.Slot.upload = upload
    devbuf.Slot.download = timed_events("d2h", real["download"])
    ec_rns._P256RNS.strip_sigma = timed_events("strip", real["strip"])
    ec_rns._P256RNS.decode_sigma = decode
    rns._sigma_to_ints = crt
    vd.verifier.verify_batch = host_marks("start", "batch_end", real["batch"])
    try:
        for _ in range(SPLIT_REPS):
            marks.clear()
            got = vd.verify(items)
            done = time.perf_counter()
            check(len(got) == len(items), "EC split flush: wrong verdict count")
            torch.cuda.synchronize()
            rows.append({
                "encode_ms": (marks["entry"] - marks["start"]) * 1e3,
                "stage_ms": (marks["upload"] - marks["entry"]) * 1e3,
                "device_host_ms": (marks["decode0"] - marks["upload"]) * 1e3,
                "h2d_ms": marks["h2d"][0].elapsed_time(marks["h2d"][1]),
                "k5_ms": marks["k5"][0].elapsed_time(marks["k5"][1]),
                "strip_ms": marks["strip"][0].elapsed_time(marks["strip"][1]),
                "d2h_ms": marks["d2h"][0].elapsed_time(marks["d2h"][1]),
                "decode_ms": (marks["decode1"] - marks["decode0"]) * 1e3,
                "decode_crt_ms": marks["crt"] * 1e3,
                "decode_inverse_ms": (marks["decode1"] - marks["decode0"] - marks["crt"]) * 1e3,
                "finish_ms": (done - marks["exit"]) * 1e3,
                "flush_ms": (done - marks["start"]) * 1e3,
            })
    finally:
        ec_rns.scalar_mult_hosts, cuda_ec.scalar_mult_cuda = real["entry"], real["k5"]
        devbuf.Slot.upload, devbuf.Slot.download = real["upload"], real["download"]
        ec_rns._P256RNS.strip_sigma = real["strip"]
        ec_rns._P256RNS.decode_sigma = real["decode"]
        rns._sigma_to_ints = real["crt"]
        del vd.verifier.verify_batch
    out = {key: statistics.median(r[key] for r in rows) for key in rows[0]}
    ctx, sigma = marks["sigma"]
    pr = P256.p
    zs = [v % pr for v in rns._sigma_to_ints(ctx, sigma[2])]
    zs = [z for z in zs if z]
    t0 = time.perf_counter()
    each = [pow(z, -1, pr) for z in zs]
    t1 = time.perf_counter()
    prefix = [1]
    for z in zs:
        prefix.append(prefix[-1] * z % pr)
    inv = pow(prefix[-1], -1, pr)
    batch = [0] * len(zs)
    for i in range(len(zs) - 1, -1, -1):
        batch[i] = inv * prefix[i] % pr
        inv = inv * zs[i] % pr
    t2 = time.perf_counter()
    check(batch == each, "batch inversion differs from the per-point inverses")
    out.update(inverse_points=len(zs), inverse_pow_ms=(t1 - t0) * 1e3,
               inverse_batch_ms=(t2 - t1) * 1e3)
    return out


def ec_record(args, launches, kernel_reps: int, **extra):
    """K5 on recorded (res, nib, engine) operands: the whole output block."""
    from bftkv_tpu_torch.ops import cuda_ec, ec_rns

    res, nib, eng = args
    t, k = res.shape[-1], eng.k
    macs_point = EC_PRODUCTS * 2 * k * (k + 1)
    n_bytes = 2 * nbytes(res) + nbytes(nib, eng.field, eng.cn.kern["E_mma"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm", "nounits")) * 1e6
    floor_ms = (t * EC_PRODUCTS * EC_ROWS_PER_POINT * EC_IMAD_PER_PAIR
                / (sms * IMAD_PER_CLOCK_PER_SM[0] * clock_hz) * 1e3)
    groups = -(-t // extra["points_per_block"])
    return kernel_record(
        "K5 ec_scalar_mult_kernel", "bftkv_tpu_torch/ops/csrc/ec_p256.cu",
        "bftkv_tpu/ops/ec_rns.py:437", launches,
        lambda: cuda_ec.scalar_mult_cuda(res, nib, eng),
        lambda: ec_rns._scalar_mult(eng, res, nib),
        t * macs_point * RNS_OPS_PER_MAC, n_bytes, kernel_reps, 1,
        rows=t, k=k, compared="(3, 2k+1, T) Jacobian residues",
        products_per_point=EC_PRODUCTS, elementwise_floor_ms=floor_ms, groups=groups,
        waves=groups / (sms * extra["blocks_per_sm"]), sm_clock_max_mhz=clock_hz / 1e6, **extra,
    )


def k5_edge_lanes(dev) -> None:
    """K5 against its plain version at T=16 on the group law's edge lanes,
    all in its first group of 8 points: identity points, scalars 0, 1, 2 (a
    doubling lane), n − 1, and the raw windows of n and n + 1
    (``time_rns.ec_operands``).  The flushes never reach n's lane, whose
    last add is P + (−P), because ``ec_rns._nibbles`` reduces scalars mod
    n; there K5 must give Z = 0 exactly in every channel."""
    from bftkv_tpu_torch.crypto.ec import P256
    from bftkv_tpu_torch.ops import cuda_ec, ec_rns
    from bftkv_tpu_torch.tools.time_rns import EC_RAW_N, ec_operands

    eng, res, nib, pts, ks = ec_operands(16, 16, dev)
    got = cuda_ec.scalar_mult_cuda(res, nib, eng)
    check(torch.equal(got, ec_rns._scalar_mult(eng, res, nib)),
          "K5 differs from its plain version on the edge lanes")
    check(not got[2, :, EC_RAW_N].any(), "K5: P + (−P) left a nonzero Z")
    check(eng.decode_points(got) == [P256.scalar_mult(p, k % P256.n) if p is not None else None
                                     for p, k in zip(pts, ks)],
          "K5 edge lanes differ from the host curve")
    print("K5 edge lanes (T=16: identities, 0, 1, 2, n - 1, raw n = P + (-P), raw n + 1 "
          "in one group): equal to the plain version, Z = 0 on the P + (-P) lane", flush=True)


def ec_phase(dev, rsa_items, rsa_expect, ec_items, ec_expect, ec_replicas) -> dict:
    """The EC paths, each counted: (a) one 4096-item EC verify flush (K5 at
    T=8192); (b) the same items through VerifyDispatcher(max_batch=1024) (K5
    at T=2048); (c) one flush of half RSA and half EC items (K1 and K5 in
    one flush); (d) 256 shares under one replica key through SignDispatcher
    (K5 at T=256), every signature checked on the host; (e) one limb-engine
    call at 8 points.  Then timed flushes, one EC verify flush split, and K5
    against its plain version on each recorded operand set."""
    from bftkv_tpu_torch.crypto import ec as host_ec
    from bftkv_tpu_torch.crypto import rsa
    from bftkv_tpu_torch.ops import cuda_ec, cuda_rns, dispatch
    from bftkv_tpu_torch.ops import ec as ec_ops

    T = lambda a: a[0].shape[-1]
    vd = dispatch.VerifyDispatcher(rsa.VerifierDomain(device=dev), max_batch=VERIFY_FLUSH,
                                   max_wait=2.0).start()
    vd_plane = dispatch.VerifyDispatcher(rsa.VerifierDomain(device=dev),
                                         max_batch=PLANE_MAX_BATCH, max_wait=0.05).start()
    sd = dispatch.SignDispatcher(rsa.SignerDomain(device=dev), max_batch=EC_SIGN_SHARES,
                                 max_wait=2.0).start()
    vd_split = dispatch.VerifyDispatcher(rsa.VerifierDomain(device=dev), pipeline=1,
                                         max_batch=VERIFY_FLUSH).start()
    launches: dict = {}
    recorded: dict = {}

    def counted(name, fn):
        with Recorder(cuda_ec, ("scalar_mult_cuda",)) as rec, \
                Recorder(ec_ops, ("scalar_mult_jac",), copy=False) as limb, Counted() as c:
            out = fn()
        check(not limb.calls["scalar_mult_jac"], f"ec {name}: the limb engine was reached")
        calls = rec.calls["scalar_mult_cuda"]
        check(len(calls) == c.launches["ec_scalar_mult"] >= 1,
              f"ec {name}: K5 launches {c.launches} for {len(calls)} recorded calls")
        launches[name] = {}
        for a in calls:
            launches[name][T(a)] = launches[name].get(T(a), 0) + 1
        recorded[name] = calls
        return out, c

    try:
        # (a) one EC verify flush of 4096 items
        (got, _dt), c = counted("verify", lambda: verify_phase(vd, ec_items))
        check(got == ec_expect, f"EC verdicts differ from the host curve on "
              f"{sum(g != e for g, e in zip(got, ec_expect))} items")
        check(c.snap.get("verify.ec", 0) == len(ec_items), f"verify.ec {c.snap.get('verify.ec')}")
        check(c.launches["ec_scalar_mult"] == c.snap.get("dispatch.flushes") == 1,
              f"EC verify flush: K5 launches {c.launches}, flushes {c.snap.get('dispatch.flushes')}")
        check(c.launches["verify"] == c.launches["pow"] == 0, f"EC verify launched {c.launches}")
        check(launches["verify"] == {2 * VERIFY_FLUSH: 1}, f"EC verify K5 shapes {launches}")
        print(f"ec verify phase: {len(ec_items)} items, {sum(ec_expect)} valid, "
              f"verify.ec={c.snap.get('verify.ec')} launches={c.launches}", flush=True)
        # (b) the plane: max_batch 1024, K5 at T=2048
        (got, _dt), c = counted("plane", lambda: verify_phase(vd_plane, ec_items))
        check(got == ec_expect, "EC plane verdicts differ from the host curve")
        flushes = c.snap.get("dispatch.flushes", 0)
        check(c.launches["ec_scalar_mult"] == flushes >= 4,
              f"EC plane: K5 launches {c.launches} for {flushes} flushes")
        check(2 * PLANE_MAX_BATCH in launches["plane"], f"EC plane K5 shapes {launches['plane']}")
        # (c) one flush of half RSA and half EC items: K1 and K5 in it
        half = VERIFY_FLUSH // 2
        mixed = [x for pair in zip(rsa_items[:half], ec_items[:half]) for x in pair]
        mixed_expect = [x for pair in zip(rsa_expect[:half], ec_expect[:half]) for x in pair]
        with Recorder(cuda_rns, ("verify_cuda",)) as rec_k1:
            (got, _dt), c = counted("mixed", lambda: verify_phase(vd, mixed))
        check(got == mixed_expect, "mixed RSA + EC flush verdicts differ from the host")
        check(c.launches["verify"] == c.launches["ec_scalar_mult"] == 1
              and c.snap.get("dispatch.flushes") == 1 and c.snap.get("verify.ec") == half,
              f"mixed flush: launches {c.launches}, snapshot {c.snap}")
        print(f"ec plane ({flushes} flushes, K5 {launches['plane']}); mixed flush: K1 "
              f"{c.launches['verify']} + K5 {launches['mixed']}, verify.ec={c.snap.get('verify.ec')} "
              f"verify.device={c.snap.get('verify.device')}", flush=True)
        # (d) 256 shares under one replica key
        (sign_items, sigs, _dt), c = counted(
            "sign", lambda: ec_sign_phase(sd, ec_replicas[0], "counted"))
        check_ec_signatures(sign_items, sigs, "EC sign")
        check(c.snap.get("ec.sign_fault", 0) == 0, f"ec.sign_fault {c.snap.get('ec.sign_fault')}")
        check(launches["sign"] == {EC_SIGN_SHARES: 1}, f"EC sign K5 shapes {launches['sign']}")
        check(c.snap.get("signdispatch.device_occupancy{width=ec}") == 1.0,
              f"EC sign occupancy {c.snap.get('signdispatch.device_occupancy{width=ec}')}")
        # (e) the limb engine, 8 points
        rng = random.Random(EC_LIMB_POINTS)
        pts = [k.public.point for k in ec_replicas[:EC_LIMB_POINTS]]
        ks = [rng.randrange(host_ec.P256.n) for _ in pts]
        with Counted() as c:
            t0 = time.perf_counter()
            got = ec_ops.scalar_mult_hosts_limb(pts, ks, device=dev)
            limb_ms = (time.perf_counter() - t0) * 1e3
        check(got == [host_ec.P256.scalar_mult(p, k) for p, k in zip(pts, ks)],
              "limb engine scalar mults differ from the host curve")
        check(c.launches["ec_scalar_mult"] == 0, "the limb engine launched K5")
        print(f"ec sign phase: {len(sigs)} signatures under one key, ec.sign_fault=0, "
              f"K5 {launches['sign']}; limb engine {EC_LIMB_POINTS} points {limb_ms:.1f} ms",
              flush=True)

        # timed flushes (after the warm-up above)
        v_s = [verify_phase(vd, ec_items)[1] for _ in range(EC_TIMED_REPS)]
        p_s = [verify_phase(vd_plane, ec_items)[1] for _ in range(EC_TIMED_REPS)]
        m_s = [verify_phase(vd, mixed)[1] for _ in range(EC_TIMED_REPS)]
        s_s = [ec_sign_phase(sd, ec_replicas[0], f"timed{r}")[2] for r in range(EC_TIMED_REPS)]
        split = split_ec_verify_flush(vd_split, ec_items)
    finally:
        for d in (vd, vd_plane, sd, vd_split):
            d.stop()
    print("ec verify flush split (median of %d, ms): " % SPLIT_REPS
          + ", ".join(f"{k.removesuffix('_ms')} {v:.4f}" for k, v in split.items()), flush=True)

    # K5 against its plain version on every recorded shape
    attrs = cuda_ec.kernel_attrs()["ec_scalar_mult"]
    by_t: dict = {}
    for phase, counts in launches.items():
        for t, n in counts.items():
            by_t.setdefault(t, {})[phase] = n
    records = []
    for phase, t, reps, what in (
        ("verify", 2 * VERIFY_FLUSH, 5, ""), ("plane", 2 * PLANE_MAX_BATCH, 10, "dispatch plane"),
        ("mixed", None, 5, "mixed RSA + EC flush"), ("sign", EC_SIGN_SHARES, 20, "EC sign flush"),
    ):
        args = [a for a in recorded[phase] if t is None or T(a) == t][0]
        rec = ec_record(args, sum(by_t[T(args)].values()), reps,
                        phase_launches=by_t[T(args)], **attrs)
        if what:
            rec["name"] += f" (T={T(args)}, {what})"
        records.append(rec)
    k5_edge_lanes(dev)
    (k1_args,) = rec_k1.calls["verify_cuda"]
    records.append(rns_record(
        "K1 rns_verify_kernel (mixed RSA + EC flush)", "verify", "bftkv_tpu/ops/pallas_rns.py:517",
        k1_args, 1, 20, 3, phase_launches={"ec_mixed": 1},
        **cuda_rns.kernel_attrs()["verify"]))
    print("K5 this run: " + ", ".join(f"T={r['rows']} {r['ms']:.4f} ms (plain {r['plain_ms']:.1f})"
                                      for r in records if r["name"].startswith("K5")),
          flush=True)
    med = statistics.median
    return {
        "verify_flush_ms_median": med(v_s) * 1e3,
        "verify_items_per_s": len(ec_items) / med(v_s),
        "plane_round_ms_median": med(p_s) * 1e3,
        "mixed_flush_ms_median": med(m_s) * 1e3,
        "sign_flush_ms_median": med(s_s) * 1e3,
        "signatures_per_s": EC_SIGN_SHARES / med(s_s),
        "limb_8_points_ms": limb_ms,
        "k5_launches": launches,
        "verify_flush_split_ms": split,
        "records": records,
    }


# -- the sidecar phase -------------------------------------------------------------


class _Tenant:
    """One tenant of the sidecar: its own channel and the three remote
    domains on it; the EC items of its verify batches stay local, on a
    VerifierDomain on the card (kernel K5 in the tenant)."""

    def __init__(self, addr: str, dev):
        from bftkv_tpu_torch.crypto import rsa
        from bftkv_tpu_torch.crypto.remote_verify import (
            RemoteModexpDomain, RemoteSignerDomain, RemoteVerifierDomain, SidecarChannel,
        )

        self.channel = SidecarChannel(addr)
        # Host clock around each round trip on the channel (frame out,
        # the sidecar's work, frame back): the rest of a tenant's call is
        # its own work (encoding, the local EC items, the spot check).
        self.request_s: list[float] = []
        real = self.channel._request

        def timed(op, payload):
            t0 = time.perf_counter()
            try:
                return real(op, payload)
            finally:
                self.request_s.append(time.perf_counter() - t0)

        self.channel._request = timed
        self.verifier = RemoteVerifierDomain(
            channel=self.channel, local=rsa.VerifierDomain(device=dev), spot_rate=1.0)
        # ... and around its EC items' verify on its own VerifierDomain (K5).
        self.local_s: list[float] = []
        local_verify = self.verifier.local.verify_batch

        def timed_local(items):
            t0 = time.perf_counter()
            try:
                return local_verify(items)
            finally:
                self.local_s.append(time.perf_counter() - t0)

        self.verifier.local.verify_batch = timed_local
        self.signer = RemoteSignerDomain(channel=self.channel)
        self.modexp = RemoteModexpDomain(channel=self.channel, spot_rate=1.0)


def _tenant_rounds(tenants, jobs, call):
    """Runs call(tenant, job) on one thread per tenant, released together;
    returns the results and each call's round-trip seconds."""
    out, rtt = [None] * len(tenants), [0.0] * len(tenants)

    def body(t):
        t0 = time.perf_counter()
        out[t] = call(tenants[t], jobs[t])
        rtt[t] = time.perf_counter() - t0

    run_threads(len(tenants), body)
    return out, rtt


def sidecar_phase(dev, rsa_items, rsa_expect, ec_items, ec_expect, replicas, seed: int) -> dict:
    """The port's crypto sidecar on a Unix socket on the card, started as
    its main() starts it (max_batch=4096), with SIDECAR_TENANTS tenant
    threads, each on its own channel: (a) the 4096 RSA verify items, 512 a
    tenant, each tenant's batch mixed with 32 of 256 EC items (which stay in
    the tenant: K5); (b) 256 sign shares under 8 replica keys, each tenant
    registering its key first; (c) 128 MODEXP items, 64 at 2048 bits and 64
    at 1024 bits.
    Every answer must equal the host's, with no tenant fallback, shed or
    error, and the sidecar's flushes must launch K1 and K2.  Then timed
    rounds, the STATS frame, K1 and K2 against their plain versions on the
    sidecar's own operands and K5 on the tenants'."""
    import tempfile

    from bftkv_tpu_torch import flags
    from bftkv_tpu_torch.cmd import verify_sidecar as vs
    from bftkv_tpu_torch.metrics import registry as metrics
    from bftkv_tpu_torch.ops import cuda_ec, cuda_rns, ec_rns, rns

    n_t = SIDECAR_TENANTS
    per = len(rsa_items) // n_t
    ec_per = SIDECAR_EC_ITEMS // n_t
    v_jobs = [rsa_items[t * per:(t + 1) * per] + ec_items[t * ec_per:(t + 1) * ec_per]
              for t in range(n_t)]
    v_want = [rsa_expect[t * per:(t + 1) * per] + ec_expect[t * ec_per:(t + 1) * ec_per]
              for t in range(n_t)]
    share = SIGN_SHARES // n_t
    keys = replicas[:n_t]
    rng = random.Random(seed + 11)
    m_per = SIDECAR_MODEXP // n_t
    m_jobs = [[(rng.getrandbits(2048), rng.getrandbits(2048), keys[t].n) for _ in range(m_per // 2)]
              + [(rng.getrandbits(1024), rng.getrandbits(1024), keys[t].p) for _ in range(m_per // 2)]
              for t in range(n_t)]

    def s_jobs(tag):
        return [[(b"sidecar-share-%s-%d-%d" % (tag.encode(), t, j), keys[t]) for j in range(share)]
                for t in range(n_t)]

    sock_dir = tempfile.mkdtemp(prefix="bftkv-sidecar-")
    addr = f"unix:{os.path.join(sock_dir, 'crypto.sock')}"
    # As main() starts it: the dispatchers' own window and the default
    # admission.  Only the online recalibration loop is off: in this
    # process the launch round trip it re-prices the crossover from is the
    # earlier phases' (EC flushes of hundreds of ms), not the sidecar's own.
    prev = flags.raw("BFTKV_DISPATCH_RECAL_S")
    os.environ.update(BFTKV_DISPATCH_RECAL_S="0")
    try:
        srv, _thread = vs.serve(addr, max_batch=VERIFY_FLUSH, device=dev)
    finally:
        if prev is None:
            os.environ.pop("BFTKV_DISPATCH_RECAL_S")
        else:
            os.environ.update(BFTKV_DISPATCH_RECAL_S=prev)
    svc = srv.service
    tenants: list = []
    quiet = ("verify.remote_fallback", "sign.remote_fallback", "modexp.remote_fallback",
             "verify.remote_shed", "sign.remote_shed", "modexp.remote_shed",
             "verify.remote_breaker_open", "verify.remote_bad_mac", "sign.remote_refused",
             "crypto.sidecar.dishonest", "sign.host", "modexp.host")

    def clean(c, what):
        bad = {k: c.snap[k] for k in quiet if c.snap.get(k)}
        check(not bad, f"sidecar {what}: a tenant fell back, was shed or saw ERR: {bad}")
        check(svc.admission.shed == 0, f"sidecar {what}: admission shed {svc.admission.shed}")

    verify_call = lambda tn, job: [bool(v) for v in tn.verifier.verify_batch(job)]
    sign_call = lambda tn, job: tn.signer.sign_batch(job)
    modexp_call = lambda tn, job: tn.modexp.powmod_batch(job)
    try:
        tenants += [_Tenant(addr, dev) for _ in range(n_t)]
        # (a) verify, counted; the tenants' EC items launch K5 in the tenants
        with Recorder(cuda_rns, ("verify_cuda", "pow_cuda")) as rec_v, \
                Recorder(cuda_ec, ("scalar_mult_cuda",)) as rec_ec, Counted() as c_v:
            got, _ = _tenant_rounds(tenants, v_jobs, verify_call)
        check(got == v_want, "sidecar verify verdicts differ from the host on "
              f"{sum(g != w for gs, ws in zip(got, v_want) for g, w in zip(gs, ws))} items")
        clean(c_v, "verify")
        rsa_n = per * n_t
        rns_capable = sum(1 for m, s, pub in rsa_items
                          if rns.context().key_rows(pub.n) is not None
                          and int.from_bytes(s, "big") < pub.n)
        check(c_v.snap.get("verify.remote", 0) == rsa_n, f"verify.remote {c_v.snap.get('verify.remote')}")
        check(c_v.snap.get("verify.device", 0) == rns_capable,
              f"sidecar verify.device {c_v.snap.get('verify.device')} != {rns_capable}")
        check(c_v.snap.get("verify.ec", 0) == SIDECAR_EC_ITEMS, f"tenant verify.ec {c_v.snap.get('verify.ec')}")
        k1 = c_v.launches["verify"]
        check(k1 >= 1, "the sidecar's verify flushes launched no K1")
        k5_calls = rec_ec.calls["scalar_mult_cuda"]
        check(len(k5_calls) == c_v.launches["ec_scalar_mult"] >= 1,
              f"the tenants' EC items: K5 launches {c_v.launches} for {len(k5_calls)} recorded calls")
        items_per_k1 = c_v.snap["verify.device"] / k1
        check(items_per_k1 > per, f"items per K1 launch {items_per_k1} <= one tenant's {per}: "
              "no coalescing across tenants")
        print(f"sidecar verify: {n_t} tenants x ({per} RSA + {ec_per} EC) items, "
              f"verify.remote={c_v.snap.get('verify.remote')} verify.device={c_v.snap['verify.device']} "
              f"flushes={c_v.snap.get('dispatch.flushes')} K1 launches {k1} "
              f"({items_per_k1:.1f} items a launch, dispatcher window "
              f"{svc.verify.max_wait * 1e3:g} ms), tenant K5 launches "
              f"{c_v.launches['ec_scalar_mult']} at T={sorted({a[0].shape[-1] for a in k5_calls})}",
              flush=True)
        # (b) sign, counted: each tenant registers its key, then signs
        with Recorder(cuda_rns, ("verify_cuda", "pow_cuda")) as rec_s, Counted() as c_s:
            jobs = s_jobs("counted")
            got, _ = _tenant_rounds(tenants, jobs, sign_call)
        for job, sigs in zip(jobs, got):
            check_signatures(job, sigs, "sidecar sign")
        clean(c_s, "sign")
        check(c_s.snap.get("sign.remote", 0) == SIGN_SHARES and c_s.snap.get("sign.device", 0)
              == SIGN_SHARES, f"sidecar sign: remote {c_s.snap.get('sign.remote')} device "
              f"{c_s.snap.get('sign.device')}")
        check(c_s.snap.get("sign.remote_register", 0) == n_t,
              f"sign.remote_register {c_s.snap.get('sign.remote_register')}")
        check(c_s.snap.get("sign.fault", 0) == 0, f"sidecar sign.fault {c_s.snap.get('sign.fault')}")
        check(c_s.launches["pow"] >= 1, "the sidecar's sign flushes launched no K2")
        print(f"sidecar sign: {SIGN_SHARES} shares under {n_t} keys, "
              f"sign.remote_register={c_s.snap['sign.remote_register']} "
              f"flushes={c_s.snap.get('signdispatch.flushes')} launches K2 {c_s.launches['pow']} "
              f"K1 {c_s.launches['verify']}", flush=True)
        # (c) modexp, counted
        with Recorder(cuda_rns, ("pow_cuda",)) as rec_m, Counted() as c_m:
            got, _ = _tenant_rounds(tenants, m_jobs, modexp_call)
        check(got == [[pow(b, e, m) for b, e, m in job] for job in m_jobs],
              "sidecar modexps differ from host pow")
        clean(c_m, "modexp")
        check(c_m.snap.get("modexp.remote", 0) == SIDECAR_MODEXP
              and c_m.snap.get("modexp.device", 0) == SIDECAR_MODEXP,
              f"sidecar modexp: remote {c_m.snap.get('modexp.remote')} device "
              f"{c_m.snap.get('modexp.device')}")
        check(c_m.launches["pow"] >= 2, f"sidecar modexp launched {c_m.launches}")
        print(f"sidecar modexp: {SIDECAR_MODEXP} items (2048 and 1024 bits), "
              f"flushes={c_m.snap.get('modexpdispatch.flushes')} K2 launches {c_m.launches['pow']}",
              flush=True)

        # timed rounds: tenant round trips, the sidecar's flushes beside them
        with FlushClock(svc.verify) as fv, FlushClock(svc.sign) as fs:
            for tn in tenants:
                tn.request_s.clear()
                tn.local_s.clear()
            metrics.reset()
            v_rtt = [_tenant_rounds(tenants, v_jobs, verify_call)[1] for _ in range(SIDECAR_ROUNDS)]
            v_req = [list(tn.request_s) for tn in tenants]
            v_local = [list(tn.local_s) for tn in tenants]
            v_snap = metrics.snapshot()
            for tn in tenants:
                tn.request_s.clear()
            s_rtt = [_tenant_rounds(tenants, s_jobs(f"timed{r}"), sign_call)[1]
                     for r in range(SIDECAR_ROUNDS)]
            s_req = [list(tn.request_s) for tn in tenants]
            s_snap = metrics.snapshot()
        stats = tenants[0].channel.stats()  # its counters: the timed rounds
        check(stats is not None and stats["device_plane"]["device"] == str(dev),
              f"sidecar STATS frame {stats}")
        rings = stats["device_plane"]["buffer_rings"]
        check(all(r["in_flight"] == 0 for r in rings.values()), f"a sidecar slot in flight: {rings}")
    finally:
        for tn in tenants:
            tn.channel.close()
        svc.stop()
        srv.shutdown()
        srv.server_close()
        try:
            os.unlink(addr[len("unix:"):])
            os.rmdir(sock_dir)
        except OSError:
            pass

    # K1 and K2 against their plain versions on the sidecar's own operands
    k1_calls = rec_v.calls["verify_cuda"] + rec_s.calls["verify_cuda"]
    k2_calls = rec_s.calls["pow_cuda"] + rec_m.calls["pow_cuda"]
    check(len(k1_calls) == c_v.launches["verify"] + c_s.launches["verify"]
          and len(k2_calls) == c_s.launches["pow"] + c_m.launches["pow"],
          "recorded sidecar launches differ from the launch counts")
    for a in k1_calls:
        g = cuda_rns.verify_cuda(*a)
        p = rns._verify_kernel(a[4], a[0], a[1], rns.gather_key(a[3], a[2]))
        check(torch.equal(g, p), f"K1 differs from its plain version on sidecar operands (T={a[0].shape[0]})")
    for a in k2_calls:
        g = cuda_rns.pow_cuda(*a)
        p = rns._pow_kernel(a[4], a[0], a[1], rns.gather_key(a[3], a[2]))
        check(torch.equal(g.long(), p.long()),
              f"K2 differs from its plain version on sidecar operands (k={a[4].k}, T={a[0].shape[0]})")
    for a in k5_calls:
        check(torch.equal(cuda_ec.scalar_mult_cuda(*a), ec_rns._scalar_mult(a[2], a[0], a[1])),
              f"K5 differs from its plain version on the tenants' operands (T={a[0].shape[-1]})")
    k5_rows = {}
    for a in k5_calls:
        k5_rows[a[0].shape[-1]] = k5_rows.get(a[0].shape[-1], 0) + 1
    k5_t = max(k5_rows, key=k5_rows.get)
    k5_rec = ec_record([a for a in k5_calls if a[0].shape[-1] == k5_t][0], len(k5_calls), 20,
                       phase_launches={"sidecar_tenants": k5_rows},
                       **cuda_ec.kernel_attrs()["ec_scalar_mult"])
    k5_rec["name"] += f" (T={k5_t}, the sidecar tenants' own EC items)"
    def by_rows(calls):
        rows = {}
        for a in calls:
            rows[a[0].shape[0]] = rows.get(a[0].shape[0], 0) + 1
        return rows

    # The flushes' shapes follow how the tenants' frames arrive: each
    # record is the first launch, beside the launches by rows.
    v0, s0 = rec_v.calls["verify_cuda"][0], rec_s.calls["pow_cuda"][0]
    records = [
        rns_record(f"K1 rns_verify_kernel (T={v0[0].shape[0]}, sidecar verify flush)", "verify",
                   "bftkv_tpu/ops/pallas_rns.py:517", v0, k1, 20, 3,
                   phase_launches={"sidecar_verify": by_rows(rec_v.calls["verify_cuda"])},
                   **cuda_rns.kernel_attrs()["verify"]),
        rns_record(f"K2 rns_pow_kernel (k=94, T={s0[0].shape[0]}, sidecar sign flush)", "pow",
                   "bftkv_tpu/ops/pallas_rns.py:403", s0, c_s.launches["pow"], 10, 2,
                   phase_launches={"sidecar_sign": by_rows(rec_s.calls["pow_cuda"])},
                   **cuda_rns.kernel_attrs()["pow"]),
        k5_rec,
    ]
    med = statistics.median
    per_tenant_v = [med(r[t] for r in v_rtt) * 1e3 for t in range(n_t)]
    per_tenant_s = [med(r[t] for r in s_rtt) * 1e3 for t in range(n_t)]
    out = {
        "tenants": n_t,
        "verify_items_per_k1_launch": items_per_k1,
        "dispatcher_window_ms": svc.verify.max_wait * 1e3,
        "admission_max_inflight": svc.admission.max_inflight,
        "launches": {"verify": dict(c_v.launches), "sign": dict(c_s.launches),
                     "modexp": dict(c_m.launches)},
        "verify_rtt_ms_median_per_tenant": per_tenant_v,
        "sign_rtt_ms_median_per_tenant": per_tenant_s,
        "verify_request_ms_median_per_tenant": [med(r) * 1e3 for r in v_req],
        "verify_local_ec_ms_median_per_tenant": [med(r) * 1e3 for r in v_local],
        "sign_request_ms_median_per_tenant": [med(r) * 1e3 for r in s_req],
        "verify_dispatch_wait_ms_p50": v_snap["dispatch.wait.p50"] * 1e3,
        "sign_dispatch_wait_ms_p50": s_snap["signdispatch.wait.p50"] * 1e3,
        "verify_flush_ms_median": med(fv.seconds) * 1e3,
        "verify_flushes_timed": len(fv.seconds),
        "sign_flush_ms_median": med(fs.seconds) * 1e3,
        "sign_flushes_timed": len(fs.seconds),
        "stats_rings": rings,
        "stats_batch": stats["batch"],
        "k1_checked": [a[0].shape[0] for a in k1_calls],
        "k2_checked": [(a[4].k, a[0].shape[0]) for a in k2_calls],
        "k5_checked": [a[0].shape[-1] for a in k5_calls],
        "records": records,
    }
    print("sidecar round trips (median of %d rounds, ms): verify per tenant %s; sign per tenant %s"
          % (SIDECAR_ROUNDS, [round(x, 3) for x in per_tenant_v], [round(x, 3) for x in per_tenant_s]),
          flush=True)
    print("sidecar round trips on the channel (median, ms): verify per tenant %s; sign per tenant %s"
          % ([round(x, 3) for x in out["verify_request_ms_median_per_tenant"]],
             [round(x, 3) for x in out["sign_request_ms_median_per_tenant"]]), flush=True)
    print("tenants' own EC items, verified in the tenant (K5; median, ms): %s"
          % [round(x, 3) for x in out["verify_local_ec_ms_median_per_tenant"]], flush=True)
    print(f"sidecar flushes (median, ms): verify {out['verify_flush_ms_median']:.3f} over "
          f"{len(fv.seconds)} flushes (dispatcher wait p50 {out['verify_dispatch_wait_ms_p50']:.3f}), "
          f"sign {out['sign_flush_ms_median']:.3f} over {len(fs.seconds)} (wait p50 "
          f"{out['sign_dispatch_wait_ms_p50']:.3f})", flush=True)
    print("sidecar STATS rings (acquires/overflows, none in flight): "
          + ", ".join(f"{k} {r['acquires']}/{r['overflows']}" for k, r in sorted(rings.items())),
          flush=True)
    return out


# -- the shard phase ---------------------------------------------------------------


def shard_phase(dev, rsa_items, replicas) -> dict:
    """The split of the RNS launches (ops/rns.py): entry.dryrun_multichip(2);
    then the verify at T=4096 and the sign modexp at k=94 T=512, split over
    two shards of this card (separate streams) and, with two or more cards,
    over every card, each bit for bit against the unsplit launch, and every
    K1 and K2 launch of the phase against its plain version."""
    from bftkv_tpu_torch import entry
    from bftkv_tpu_torch.crypto import rsa
    from bftkv_tpu_torch.ops import cuda_rns, rns

    count = torch.cuda.device_count()
    print(f"shard phase: torch.cuda.device_count() = {count}", flush=True)
    os.environ.update(BFTKV_SHARD="auto")
    recorded = {"verify_cuda": [], "pow_cuda": []}  # (run, args) of every launch
    with Recorder(cuda_rns, ("verify_cuda", "pow_cuda")) as rec, Counted() as c_d:
        dry = entry.dryrun_multichip(2)
    check(c_d.launches["verify"] == 2 and c_d.launches["pow"] == dry["pow_shards"] == 2,
          f"dryrun_multichip(2) launched {c_d.launches}, pow shards {dry['pow_shards']}")
    for fn, calls in rec.calls.items():
        recorded[fn] += [("dryrun", a) for a in calls]

    ctx = rns.context()
    unique, urows, idx, sigs, ems = {}, [], [], [], []
    for m, s, pub in rsa_items:
        kr, sv = ctx.key_rows(pub.n), int.from_bytes(s, "big")
        if kr is None or sv >= pub.n:
            continue
        if pub.n not in unique:
            unique[pub.n] = len(urows)
            urows.append(kr)
        idx.append(unique[pub.n])
        sigs.append(sv)
        ems.append(rsa.emsa_pkcs1v15_sha256(m, pub.size_bytes))
    rng = random.Random(len(sigs))
    bases, exps, mods = [], [], []
    for j in range(SIGN_SHARES):
        key = replicas[j % len(replicas)]
        c = rng.randrange(key.n)
        for pr in (key.p, key.q):
            bases.append(c % pr)
            exps.append(key.d % (pr - 1))
            mods.append(pr)
    want_pow = [pow(b, e, m) for b, e, m in zip(bases, exps, mods)]

    def run(name, shards):
        scope = rns.shard_over(shards) if shards else contextlib.nullcontext()
        rec = Recorder(cuda_rns, ("verify_cuda", "pow_cuda"))
        with scope, rec, Counted() as c:
            t0 = time.perf_counter()
            v = rns.verify_e65537_rns_indexed(sigs, ems, idx, urows, device=dev)
            t1 = time.perf_counter()
            p = rns.power_mod_rns(bases, exps, mods, n_bits=1024, device=dev)
            t2 = time.perf_counter()
        for fn, calls in rec.calls.items():
            check(len(calls) == c.launches["verify" if fn == "verify_cuda" else "pow"],
                  f"shard {name}: {len(calls)} recorded {fn} calls, launches {c.launches}")
            recorded[fn] += [(name, a) for a in calls]
        return v, p, c.launches, (t1 - t0) * 1e3, (t2 - t1) * 1e3

    v0, p0, l0, v0_ms, p0_ms = run("unsplit", [dev])  # one shard: the unsplit launch
    check(p0 == want_pow, "unsplit sign modexp differs from host pow")
    check(l0["verify"] == 1 and l0["pow"] == 1, f"unsplit launches {l0}")
    out = {"device_count": count, "dryrun": dry, "dryrun_launches": dict(c_d.launches),
           "verify_rows": len(sigs), "pow_rows": len(bases),
           "unsplit": {"verify_ms": v0_ms, "pow_ms": p0_ms, "launches": dict(l0)}}
    runs = [("one_card_two_streams", [dev, dev])]
    if count >= 2:
        runs.append(("every_card", None))  # the default split: every local card
    for name, shards in runs:
        v, p, launches, v_ms, p_ms = run(name, shards)
        n = len(shards) if shards else count
        check(v.shape == v0.shape and bool((v == v0).all()),
              f"split verify ({name}) differs from the unsplit launch")
        check(p == p0, f"split sign modexp ({name}) differs from the unsplit launch")
        check(launches["verify"] == n and launches["pow"] == n, f"split ({name}) launched {launches}")
        out[name] = {"shards": n, "verify_ms": v_ms, "pow_ms": p_ms, "launches": dict(launches)}
    print(f"shard phase: dryrun_multichip(2) votes {dry['votes']}/{dry['batch']} on {dry['devices']}; "
          f"split verify T={rns._pad_rows(len(sigs), 256)} and pow k=94 T={len(bases)} bit-identical to unsplit: "
          + ", ".join(f"{k} ({out[k]['shards']} shards, verify {out[k]['verify_ms']:.1f} ms, "
                      f"pow {out[k]['pow_ms']:.1f} ms)" for k, _s in runs)
          + f"; unsplit verify {v0_ms:.1f} ms, pow {p0_ms:.1f} ms (host clock)", flush=True)

    # Every K1 and K2 launch of the phase against its plain version, on its
    # own card; records at the two-shard shapes of one card.
    for fn, plain in (("verify_cuda", rns._verify_kernel), ("pow_cuda", rns._pow_kernel)):
        for name, a in recorded[fn]:
            with torch.cuda.device(a[0].device):
                g = getattr(cuda_rns, fn)(*a)
                p = plain(a[4], a[0], a[1], rns.gather_key(a[3], a[2]))
                check(torch.equal(g.long(), p.long()), f"shard {name}: {fn} differs from its plain "
                      f"version (k={a[4].k}, T={a[0].shape[0]}, {a[0].device})")
    out["checked"] = {fn: [(name, a[4].k, a[0].shape[0], str(a[0].device)) for name, a in calls]
                      for fn, calls in recorded.items()}
    two = [a for name, a in recorded["verify_cuda"] if name == "one_card_two_streams"]
    two_pow = [a for name, a in recorded["pow_cuda"] if name == "one_card_two_streams"]
    attrs = cuda_rns.kernel_attrs()
    out["records"] = [
        rns_record(f"K1 rns_verify_kernel (T={two[0][0].shape[0]}, one of two shards)", "verify",
                   "bftkv_tpu/ops/pallas_rns.py:517", two[0], len(two), 20, 3,
                   phase_launches={"shard_one_card_two_streams": len(two)}, **attrs["verify"]),
        rns_record(f"K2 rns_pow_kernel (k=94, T={two_pow[0][0].shape[0]}, one of two shards)", "pow",
                   "bftkv_tpu/ops/pallas_rns.py:403", two_pow[0], len(two_pow), 10, 2,
                   phase_launches={"shard_one_card_two_streams": len(two_pow)}, **attrs["pow"]),
    ]
    print("shard phase: every K1 and K2 launch (%d and %d, dryrun included) equal to its plain version"
          % (len(recorded["verify_cuda"]), len(recorded["pow_cuda"])), flush=True)
    return out


# -- the quorum phase ------------------------------------------------------------


def hold_rns_calls(k1_calls, k2_calls, what: str) -> None:
    """Every recorded K1 and K2 launch against its plain version: the rows of
    one kernel and context concatenated into plain runs of whole launches,
    at most HOLD_ROWS rows a run where the launches allow."""
    from bftkv_tpu_torch.ops import cuda_rns, rns

    for which, calls, plain in (("verify", k1_calls, rns._verify_kernel), ("pow", k2_calls, rns._pow_kernel)):
        by_k = {}
        for part, a in calls:
            by_k.setdefault(a[4].k, []).append((part, a))
        runs = []
        for k, group in by_k.items():
            run, rows = [], 0
            for part, a in group:
                if run and rows + a[0].shape[0] > HOLD_ROWS:
                    runs.append((k, run))
                    run, rows = [], 0
                run.append((part, a))
                rows += a[0].shape[0]
            runs.append((k, run))
        for k, group in runs:
            kern = [(getattr(cuda_rns, f"{which}_cuda")(*a)) for _p, a in group]
            cn = group[0][1][4]
            keys_ = [rns.gather_key(a[3], a[2]) for _p, a in group]
            key = tuple(torch.cat([kk[i] for kk in keys_]) for i in range(len(keys_[0])))
            first = torch.cat([a[0] for _p, a in group])
            second = torch.cat([a[1] for _p, a in group], dim=0 if which == "verify" else 1)
            p_all = plain(cn, first, second, key)
            check(torch.equal(torch.cat([g.long() for g in kern]), p_all.long()),
                  f"{'K1' if which == 'verify' else 'K2'} (k={k}) differs from its plain version on the "
                  f"{what}'s operands")


def _shapes(calls, rows_of):
    by = {}
    for part, a in calls:
        key = rows_of(a)
        by.setdefault(key, {"args": a, "parts": {}})
        by[key]["parts"][part] = by[key]["parts"].get(part, 0) + 1
    return by


def rns_shape_records(k1_calls, k2_calls, label: str) -> list:
    """A kernel record for each (kernel, context, rows) shape of a phase."""
    from bftkv_tpu_torch.ops import cuda_rns

    attrs = cuda_rns.kernel_attrs()
    records = []
    for (k, t), v in sorted(_shapes(k1_calls, lambda a: (a[4].k, a[0].shape[0])).items()):
        records.append(rns_record(f"K1 rns_verify_kernel (T={t}, {label})", "verify",
                                  "bftkv_tpu/ops/pallas_rns.py:517", v["args"], sum(v["parts"].values()),
                                  20, 2, phase_launches=v["parts"], **attrs["verify"]))
    for (k, t), v in sorted(_shapes(k2_calls, lambda a: (a[4].k, a[0].shape[0])).items()):
        records.append(rns_record(f"K2 rns_pow_kernel (k={k}, T={t}, {label})", "pow",
                                  "bftkv_tpu/ops/pallas_rns.py:403", v["args"], sum(v["parts"].values()),
                                  5, 1, phase_launches=v["parts"], **attrs["pow"]))
    return records


def _fill_sweep(root: str, engine: str, cap: int, seed: int) -> dict:
    """``bench.py``'s raw-engine fill sweep on one engine (fsync off, 64-byte
    payloads): p50 of FILL_PROBES timed writes at each resident-key point up
    to ``cap``, then a seeded sample of the filled keys read back."""
    from bftkv_tpu_torch.storage.logkv import LogStorage
    from bftkv_tpu_torch.storage.native import NativeStorage
    from bftkv_tpu_torch.storage.plain import PlainStorage

    path = os.path.join(root, f"fill-{engine}")
    s = {"log": lambda: LogStorage(path, fsync=False), "native": lambda: NativeStorage(path + ".kv"),
         "plain": lambda: PlainStorage(path, fsync=False)}[engine]()
    payload = b"p" * 64
    row = {}
    filled = 0
    t0 = time.perf_counter()
    for n in [p for p in FILL_POINTS if p <= cap]:
        while filled < n:
            s.write(b"fill-%09d" % filled, 1, payload)
            filled += 1
        lat = []
        for i in range(FILL_PROBES):
            t1 = time.perf_counter()
            s.write(b"probe-%d-%09d" % (n, i), 1, payload)
            lat.append(time.perf_counter() - t1)
        row["p50_us_at_%d" % n] = statistics.median(lat) * 1e6
    row["fill_s"] = time.perf_counter() - t0
    sample = random.Random(seed).sample(range(filled), min(FILL_READBACK, filled))
    t0 = time.perf_counter()
    bad = sum(s.read(b"fill-%09d" % i) != payload for i in sample)
    row["readback_keys"] = len(sample)
    row["readback_ms"] = (time.perf_counter() - t0) * 1e3
    check(bad == 0, f"{engine}: {bad} of {len(sample)} filled keys read back wrong at {filled} keys")
    if hasattr(s, "close"):
        s.close()
    return row


def quorum_phase(dev, replicas, writers, storage_keys, seed: int) -> tuple[dict, dict]:
    """The trust graph, the web-of-trust quorums, the tallies and the stores
    (the port of bftkv_tpu/graph.py, quorum/, regions/, storage/ and
    topology.py) at the headline cluster's width: (a) the universe built
    with topology.build_universe (64 servers cross-signed, 8 rw nodes, the
    4 writers) and make_node for all 76 principals; every server's AUTH
    quorum and every writer's keyed AUTH|PEER quorum is the 64-clique at
    f=21, min=64, threshold=43, suff=43, and WRITE adds the rw nodes; (b)
    the 93 writes certified as the protocol's client certifies them: the
    writer's signature, then the shares of 43 servers issued through
    Signer.issue_many with the dispatchers installed (K2 k=94, K1 fault
    checks), combined against the writer's quorum (complete exactly at the
    43rd), and verify_many per writer (K1); (c) 4096 candidate sets tallied
    on the card (ops/tally.py) against the host predicates, and the
    equivocation tally at universe 256 with 85 colluders; (d) every
    storage-holding principal's LogStorage (durable default) takes the 93
    packets in one write_batch, is closed, reopened and read back, one
    replica re-verifies its 93 collective signatures (K1), one store is
    compacted and read back, and a NativeStorage does the same; (e) the
    fill sweep.  Every K1 and K2 launch of the phase is held against its
    plain version.  Returns the phase's record and the writers' nodes and
    quorums, which the crypto-layer phase takes."""
    import shutil
    import tempfile

    import numpy as np

    from bftkv_tpu_torch import packet, topology
    from bftkv_tpu_torch import quorum as q
    from bftkv_tpu_torch.crypto import signature, vcache
    from bftkv_tpu_torch.ops import cuda_rns, dispatch, tally
    from bftkv_tpu_torch.quorum.wotqs import bmasking_params
    from bftkv_tpu_torch.storage import open_engine
    from bftkv_tpu_torch.storage.compact import compact_store
    from bftkv_tpu_torch.storage.native import NativeStorage

    os.environ.update(BFTKV_SHARD="off")
    t_phase = time.perf_counter()
    out = {}
    k1_calls, k2_calls = [], []
    launch_names = ("verify_cuda", "pow_cuda")

    def keep(part, rec):
        k1_calls.extend((part, a) for a in rec.calls["verify_cuda"])
        k2_calls.extend((part, a) for a in rec.calls["pow_cuda"])

    # (a) the universe and the 76 nodes
    t0 = time.perf_counter()
    uni = topology.build_universe(N_REPLICAS, N_WRITERS, N_STORAGE, bits=2048,
                                  keys=replicas + storage_keys + writers)
    views = {i.name: uni.view_of(i) for i in uni.all}
    build_ms = (time.perf_counter() - t0) * 1e3
    cross = sum(len(s.cert.signers()) - 1 for s in uni.servers)
    check(cross == N_REPLICAS * (N_REPLICAS - 1), f"{cross} cross-signatures on the server certificates")
    t0 = time.perf_counter()
    nodes = {i.name: topology.make_node(i, views[i.name], uni.local_trust_of(i), device=dev) for i in uni.all}
    make_ms = (time.perf_counter() - t0) * 1e3
    server_ids = {s.id for s in uni.servers}
    rw_ids = {s.id for s in uni.storage_nodes}
    want = bmasking_params(N_REPLICAS)
    check(want == (CERT_K - 1, N_REPLICAS, AUTH_K, SUFF), f"bmasking_params({N_REPLICAS}) = {want}")

    def bounds_of(qr):
        b = qr.bounds()
        return [tuple(int(b[k][i]) for k in ("f", "min", "threshold", "suff")) for i in range(len(qr.qcs))]

    t0 = time.perf_counter()
    for s in uni.servers:
        qa = nodes[s.name][2].choose_quorum(q.AUTH)
        check(set(qa.membership_matrix()[1]) == server_ids and bounds_of(qa) == [want],
              f"{s.name}'s AUTH quorum is not the {N_REPLICAS}-clique at {want}: {bounds_of(qa)}")
    writer_nodes, writer_quorums = [], []
    for u in uni.users:
        g, crypt, qs = nodes[u.name]
        qa = qs.choose_quorum_for(b"x", q.AUTH | q.PEER)
        check(set(qa.membership_matrix()[1]) == server_ids and bounds_of(qa) == [want],
              f"{u.name}'s AUTH|PEER quorum is not the {N_REPLICAS}-clique at {want}: {bounds_of(qa)}")
        qw = qs.choose_quorum(q.WRITE | q.AUTH)
        check({n.id for n in qw.nodes()} == server_ids | rw_ids,
              f"{u.name}'s WRITE|AUTH quorum holds {len(qw.nodes())} addressed nodes, not the clique and the rw nodes")
        check({n.id for n in qs.choose_quorum(q.WRITE).nodes()} == rw_ids,
              f"{u.name}'s WRITE quorum is not the {N_STORAGE} rw nodes")
        writer_nodes.append((g, crypt, qs))
        writer_quorums.append(qa)
    quorum_ms = (time.perf_counter() - t0) * 1e3
    out["universe"] = {"servers": N_REPLICAS, "storage": N_STORAGE, "writers": N_WRITERS,
                       "cross_signatures": cross, "build_ms": build_ms, "make_node_ms": make_ms,
                       "nodes": len(nodes), "quorum_checks_ms": quorum_ms,
                       "f_min_threshold_suff": list(want)}
    print(f"quorum (a) universe: {N_REPLICAS} servers ({cross} cross-signatures), {N_STORAGE} rw, "
          f"{N_WRITERS} writers built with their {len(views)} views in {build_ms:.1f} ms; "
          f"{len(nodes)} make_node calls in {make_ms:.1f} ms; every server's AUTH and every writer's "
          f"AUTH|PEER quorum is the {N_REPLICAS}-clique at f, min, threshold, suff = {want}; "
          f"WRITE adds the {N_STORAGE} rw nodes", flush=True)

    # (b) the 93 writes, certified as the protocol's client certifies them
    recs = []  # (writer index, x, v, t, sig, tbss)
    for w in range(N_WRITES):
        wi = w % N_WRITERS
        x, v, t = b"smoke/%d" % w, b"value-%d-seed-%d" % (w, seed), 1
        sig = writer_nodes[wi][1].signer.issue(packet.serialize(x, v, t, nfields=3))
        recs.append((wi, x, v, t, sig, packet.serialize(x, v, t, sig, nfields=4)))
    plan = {}
    for w in range(N_WRITES):
        for j in range(SUFF):
            plan.setdefault((7 * w + j) % N_REPLICAS, []).append(w)
    order = sorted(plan)
    issued = {}
    vd = dispatch.install(dispatch.VerifyDispatcher(device=dev))
    dispatch.install_signer(dispatch.SignDispatcher(device=dev))
    try:
        with Recorder(cuda_rns, launch_names) as rec, Counted() as c_sign:
            t0 = time.perf_counter()
            run_threads(len(order), lambda i: issued.__setitem__(order[i], nodes[uni.servers[order[i]].name][1]
                                                                 .signer.issue_many([recs[w][5] for w in plan[order[i]]])))
            sign_ms = (time.perf_counter() - t0) * 1e3
        keep("certify_sign", rec)
        check(c_sign.launches["pow"] >= 1 and c_sign.launches["verify"] >= 1,
              f"the shares' Signer.issue_many launched {c_sign.launches}")
        pos = {i: 0 for i in plan}
        shares_of = [[] for _ in range(N_WRITES)]
        for i in order:
            for w in plan[i]:
                shares_of[w].append(issued[i][pos[i]])
                pos[i] += 1
        t0 = time.perf_counter()
        ss_of = []
        for w, (wi, *_r) in enumerate(recs):
            crypt, qa = writer_nodes[wi][1], writer_quorums[wi]
            ss, done_at = None, []
            for share in shares_of[w]:
                ss, done = crypt.collective.combine(ss, share, qa, crypt.keyring)
                done_at.append(done)
            check(done_at == [False] * (SUFF - 1) + [True],
                  f"write {w}: the combine was sufficient after {done_at.index(True) + 1 if True in done_at else None} "
                  f"shares, not {SUFF}")
            ss_of.append(ss)
        combine_ms = (time.perf_counter() - t0) * 1e3
        vcache.reset()  # the shares' own signatures seeded the memo
        errs = [None] * N_WRITES
        with Recorder(cuda_rns, launch_names) as rec, Counted() as c_ver:
            t0 = time.perf_counter()
            for wi in range(N_WRITERS):
                ws = [w for w in range(N_WRITES) if recs[w][0] == wi]
                crypt = writer_nodes[wi][1]
                res = crypt.collective.verify_many([(recs[w][5], ss_of[w]) for w in ws],
                                                   writer_quorums[wi], crypt.keyring)
                for w, e in zip(ws, res):
                    errs[w] = e
            verify_ms = (time.perf_counter() - t0) * 1e3
        keep("certify_verify", rec)
        check(errs == [None] * N_WRITES, f"{sum(e is not None for e in errs)} certified writes fail verify_many")
        check(c_ver.launches["verify"] >= 1 and c_ver.snap.get("verify.cache.hits", 0) == 0,
              f"verify_many launched {c_ver.launches}, memo hits {c_ver.snap.get('verify.cache.hits', 0)}")
    finally:
        dispatch.uninstall_all()
    packets = [(x, t, packet.serialize(x, v, t, sig, ss_of[w])) for w, (_wi, x, v, t, sig, _tb) in enumerate(recs)]
    out["certify"] = {"writes": N_WRITES, "shares": sum(len(v) for v in plan.values()), "sign_ms": sign_ms,
                      "combine_ms": combine_ms, "verify_many_ms": verify_ms,
                      "sign_launches": dict(c_sign.launches), "verify_launches": dict(c_ver.launches),
                      "k1_rows": [a[0].shape[0] for p, a in k1_calls if p == "certify_verify"]}
    print(f"quorum (b) certify: {out['certify']['shares']} shares of {N_WRITES} writes through "
          f"Signer.issue_many in {sign_ms:.1f} ms (K2 {c_sign.launches['pow']}, K1 fault checks "
          f"{c_sign.launches['verify']}); combined against each writer's quorum, complete at share {SUFF}, "
          f"in {combine_ms:.1f} ms; verify_many per writer {verify_ms:.1f} ms (K1 {c_ver.launches['verify']} "
          f"at T={out['certify']['k1_rows']}); all {N_WRITES} sufficient", flush=True)

    # (c) the tallies on the card against the host predicates
    qa = writer_quorums[0]
    membership, index = qa.membership_matrix()
    bounds = qa.bounds()
    ids = list(index)
    by_id = {n.id: n for qc in qa.qcs for n in qc.nodes}
    trng = np.random.default_rng(seed)
    sets = [[sid for sid, _s in signature.parse_entries(ss.data)] for ss in ss_of]
    while len(sets) < TALLY_SETS:
        k = int(trng.integers(TALLY_SIZES[0], TALLY_SIZES[1] + 1))
        sets.append([ids[j] for j in trng.choice(len(ids), size=min(k, len(ids)), replace=False)])
    cand = np.stack([qa.mask_of([by_id[i] for i in s if i in by_id]) for s in sets])
    t0 = time.perf_counter()
    host = {
        "threshold": [qa.is_threshold([by_id[i] for i in s]) for s in sets],
        "quorum": [qa.is_quorum([by_id[i] for i in s]) for s in sets],
        "sufficient": [qa.is_sufficient([by_id[i] for i in s]) for s in sets],
        "reject": [qa.reject([by_id[i] for i in s]) for s in sets],
    }
    host_ms = (time.perf_counter() - t0) * 1e3
    m_dev = torch.as_tensor(membership, device=dev)
    c_dev = torch.as_tensor(cand, device=dev)

    def card():
        return {
            "threshold": tally.is_threshold_batch(m_dev, c_dev, bounds["threshold"]),
            "quorum": tally.is_quorum_batch(m_dev, c_dev, bounds["f"], bounds["min"]),
            "sufficient": tally.is_sufficient_batch(m_dev, c_dev, bounds["suff"]),
            "reject": tally.reject_batch(m_dev, c_dev, bounds["f"]),
        }

    got = card()
    for k in host:
        rows = got[k].cpu().tolist()
        check(got[k].device.type == "cuda", f"the {k} tally ran on {got[k].device}")
        check(rows == host[k], f"the card's {k} tally differs from the host predicate on "
              f"{sum(a != b for a, b in zip(rows, host[k]))} of {len(sets)} sets")
    check(all(host["sufficient"][:N_WRITES]), "a certified write's signer set is not sufficient on the host")
    tally_ms = cuda_ms(card, TALLY_REPS)
    byz = np.zeros(EQUIV_UNIVERSE, dtype=bool)
    byz[EQUIV_UNIVERSE - EQUIV_BYZ:] = True
    honest = np.zeros((2, EQUIV_UNIVERSE), dtype=bool)
    honest[0, : EQUIV_UNIVERSE // 2] = True
    honest[1, EQUIV_UNIVERSE // 2: EQUIV_UNIVERSE - EQUIV_BYZ] = True
    signer_sets = honest | byz  # the colluders sign both values
    one = tally.equivocation_pairs(torch.as_tensor(signer_sets, device=dev))
    check(one.cpu().numpy().tolist() == byz.tolist(), f"equivocation_pairs flagged {int(one.sum())}, "
          f"not the {EQUIV_BYZ} colluders")
    # EQUIV_PAIRS independent (2, U) tallies in one call: the pairs side by side.
    pairs = torch.as_tensor(np.broadcast_to(signer_sets, (EQUIV_PAIRS,) + signer_sets.shape).copy(), device=dev)
    flat = pairs.permute(1, 0, 2).reshape(2, EQUIV_PAIRS * EQUIV_UNIVERSE)
    mask = tally.equivocation_pairs(flat).reshape(EQUIV_PAIRS, EQUIV_UNIVERSE)
    check(bool((mask == torch.as_tensor(byz, device=dev)).all()) and int(mask.sum()) == EQUIV_PAIRS * EQUIV_BYZ,
          f"the batched equivocation tally flagged {int(mask.sum())}, not {EQUIV_PAIRS} x {EQUIV_BYZ}")
    equiv_ms = cuda_ms(lambda: tally.equivocation_pairs(flat), TALLY_REPS)
    out["tallies"] = {"sets": len(sets), "written_sets": N_WRITES, "sizes": list(TALLY_SIZES),
                      "predicates_ms": tally_ms, "sets_per_s": 4 * len(sets) / (tally_ms / 1e3),
                      "host_predicates_ms": host_ms,
                      "sufficient": sum(host["sufficient"]), "threshold": sum(host["threshold"]),
                      "quorum": sum(host["quorum"]), "reject": sum(host["reject"]),
                      "equivocation": {"universe": EQUIV_UNIVERSE, "byzantine": EQUIV_BYZ,
                                       "pairs": EQUIV_PAIRS, "detected": int(one.sum()), "ms": equiv_ms,
                                       "tallies_per_s": EQUIV_PAIRS / (equiv_ms / 1e3)}}
    print(f"quorum (c) tallies: {len(sets)} sets x 4 predicates on the card in {tally_ms:.4f} ms "
          f"({out['tallies']['sets_per_s']:.0f} set tallies/s), equal to the host predicates row by row "
          f"({host_ms:.1f} ms on the host; sufficient {sum(host['sufficient'])}, reject "
          f"{sum(host['reject'])}); equivocation at universe {EQUIV_UNIVERSE}: exactly the {EQUIV_BYZ} "
          f"colluders, {EQUIV_PAIRS} pairs in {equiv_ms:.4f} ms "
          f"({out['tallies']['equivocation']['tallies_per_s']:.0f} tallies/s)", flush=True)

    # (d) the replicas' stores: an acknowledged write reads back
    holders = uni.servers + uni.storage_nodes
    tmp = tempfile.mkdtemp(prefix="smoke-stores-")
    try:
        def read_back(s, what):
            for x, t, raw in packets:
                got_raw = s.read(x, t)
                check(got_raw == raw and s.read(x) == raw and s.versions(x) == [t],
                      f"{what}: {x!r} does not read back")
                p = packet.parse(got_raw)
                check((p.variable, p.t) == (x, t) and p.ss.data == packet.parse(raw).ss.data,
                      f"{what}: {x!r} does not parse back")

        t0 = time.perf_counter()
        stores = {h.name: open_engine("log", os.path.join(tmp, h.name)) for h in holders}
        check(all(s.fsync for s in stores.values()), "a replica's LogStorage is not durable")
        pending = [(x, t, packet.serialize(x, v, t, sig, signature.SignaturePacket(
            completed=False, data=signature.serialize_entries(signature.parse_entries(ss_of[w].data)[:1]))))
            for w, (_wi, x, v, t, sig, _tb) in enumerate(recs)]
        compacted = holders[0].name
        # The compacted store first holds each write's pending record, which
        # the certified back-fill then supersedes (dead bytes to reclaim).
        stores[compacted].write_batch(pending)
        run_threads(len(holders), lambda i: stores[holders[i].name].write_batch(packets))
        write_ms = (time.perf_counter() - t0) * 1e3
        for s in stores.values():
            s.close()
        t0 = time.perf_counter()
        stores = {h.name: open_engine("log", os.path.join(tmp, h.name)) for h in holders}
        reopen_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for name, s in stores.items():
            read_back(s, f"{name}'s LogStorage after reopen")
        read_ms = (time.perf_counter() - t0) * 1e3
        # One replica re-verifies its stored collective signatures (K1).
        g, crypt, qs = nodes[holders[1].name]
        stored = [packet.parse(stores[holders[1].name].read(x, t)) for x, t, _raw in packets]
        vcache.reset()
        with Recorder(cuda_rns, launch_names) as rec, Counted() as c_re:
            t0 = time.perf_counter()
            res = crypt.collective.verify_many(
                [(packet.serialize(p.variable, p.value, p.t, p.sig, nfields=4), p.ss) for p in stored],
                qs.choose_quorum(q.AUTH), crypt.keyring)
            reverify_ms = (time.perf_counter() - t0) * 1e3
        keep("store_reverify", rec)
        check(res == [None] * N_WRITES, f"{sum(e is not None for e in res)} stored writes fail the re-verify")
        check(c_re.launches["verify"] >= 1, f"the stores' re-verify launched {c_re.launches}")
        s = stores[compacted]
        s.seal_active()
        dead = s.dead_ratio()
        t0 = time.perf_counter()
        cstats = compact_store(s)
        compact_ms = (time.perf_counter() - t0) * 1e3
        # The superseded pending copies are dead bytes; no certified record
        # is dropped.
        check(cstats["kept"] == N_WRITES and cstats["dropped"] == 0 and cstats["reclaimed_bytes"] > 0,
              f"compaction kept {cstats['kept']}, dropped {cstats['dropped']}, reclaimed "
              f"{cstats['reclaimed_bytes']} bytes")
        read_back(s, "the compacted LogStorage")
        s.reopen()
        read_back(s, "the compacted LogStorage after reopen")
        for s in stores.values():
            s.close()
        nat_path = os.path.join(tmp, "native.kv")
        t0 = time.perf_counter()
        nat = NativeStorage(nat_path)
        for x, t, raw in packets:
            nat.write(x, t, raw)
        nat.close()
        nat = NativeStorage(nat_path)
        read_back(nat, "NativeStorage after reopen")
        nat.close()
        native_ms = (time.perf_counter() - t0) * 1e3
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["stores"] = {"engine": "log", "stores": len(holders), "writes_each": N_WRITES,
                     "write_batch_ms": write_ms, "reopen_ms": reopen_ms, "read_back_ms": read_ms,
                     "reverify_ms": reverify_ms, "reverify_launches": dict(c_re.launches),
                     "reverify_k1_rows": [a[0].shape[0] for p, a in k1_calls if p == "store_reverify"],
                     "compaction": {**cstats, "dead_ratio_before": dead, "ms": compact_ms},
                     "native_ms": native_ms}
    print(f"quorum (d) stores: {len(holders)} durable LogStorages took the {N_WRITES} certified packets "
          f"in one write_batch each ({write_ms:.1f} ms), reopened in {reopen_ms:.1f} ms, every write read "
          f"back and parsed ({read_ms:.1f} ms); {holders[1].name} re-verified its {N_WRITES} collective "
          f"signatures in {reverify_ms:.1f} ms (K1 {c_re.launches['verify']}); compaction of {compacted} "
          f"(dead ratio {dead:.3f}) kept {cstats['kept']}, reclaimed {cstats['reclaimed_bytes']} bytes, read back; "
          f"NativeStorage wrote, reopened and read back all {N_WRITES} in {native_ms:.1f} ms", flush=True)

    # (e) the fill sweep at the reference's own points
    tmp = tempfile.mkdtemp(prefix="smoke-fill-")
    try:
        fill = {engine: _fill_sweep(tmp, engine, cap, seed) for engine, cap in
                (("log", FILL_POINTS[-1]), ("native", FILL_POINTS[-1]), ("plain", PLAIN_FILL_CAP))}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    first, last = FILL_POINTS[0], FILL_POINTS[-1]
    fill["log_p50_ratio_%dx" % (last // first)] = (fill["log"]["p50_us_at_%d" % last]
                                                    / fill["log"]["p50_us_at_%d" % first])
    fill["cuts"] = [f"PlainStorage filled to {PLAIN_FILL_CAP} keys only (one file per version)"]
    out["fill"] = fill
    for engine in ("log", "native", "plain"):
        r = fill[engine]
        print(f"quorum (e) fill {engine}: write p50 " + ", ".join(
            f"{p // 1000}k {r['p50_us_at_%d' % p]:.3f} us" for p in FILL_POINTS if "p50_us_at_%d" % p in r)
            + f"; {r['readback_keys']} keys read back; fill {r['fill_s']:.1f} s", flush=True)
    print(f"quorum (e) fill: log p50 ratio {last // first}x keys "
          f"{fill['log_p50_ratio_%dx' % (last // first)]:.3f}; cut: {fill['cuts'][0]}", flush=True)

    hold_rns_calls(k1_calls, k2_calls, "quorum phase")
    torch.cuda.synchronize()
    held = {"K1": len(k1_calls), "K2": len(k2_calls)}
    print(f"quorum: every launch of the phase equal to its plain version ({held}); phase "
          f"{time.perf_counter() - t_phase:.1f} s on {nvidia_smi('name,power.limit')}", flush=True)
    out["records"] = rns_shape_records(k1_calls, k2_calls, "quorum phase")
    out["held_against_plain"] = held
    out["phase_s"] = time.perf_counter() - t_phase
    return out, {"universe": uni, "writer_nodes": writer_nodes, "writer_quorums": writer_quorums}


# -- the crypto-layer phase ---------------------------------------------------------


def _load_dsa_group(seed: int, build_dir: str):
    """The threshold-DSA key (2048-bit p, 256-bit q), drawn from ``seed``
    and cached beside the smoke's keys."""
    from bftkv_tpu_torch.crypto.threshold import dsa as tdsa

    path = os.path.join(build_dir, f"smoke_dsa_seed{seed}.json")
    if os.path.exists(path):
        with open(path) as f:
            c = json.load(f)
        key = tdsa.DSAPrivateKey(**{k: int(v, 16) for k, v in c.items()})
    else:
        key = tdsa.generate(2048, seed=seed)
        os.makedirs(build_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump({k: hex(getattr(key, k)) for k in ("p", "q", "g", "x", "y")}, f)
    check(key.p.bit_length() == 2048 and key.q.bit_length() == 256 and (key.p - 1) % key.q == 0
          and pow(key.g, key.q, key.p) == 1 and key.y == pow(key.g, key.x, key.p), "bad cached DSA group")
    return key


def _threshold_round(client_ctx, servers, shares, nodes, proc, pool):
    """Drives one dealerless threshold signature (dsa_core's three phases):
    each phase's first 2t targets answer in ``pool``'s threads, their
    responses are fed to ``proc`` in order until it advances."""
    from bftkv_tpu_torch import errors

    for _ in range(4):
        target, req = proc.make_request()
        if not target:
            break
        target = target[: 2 * client_ctx.t]
        futs = [pool.submit(servers[n.id].sign, shares[n.id], req, 0xC11E47, n.id) for n in target]
        for node, fut in zip(target, futs):
            res = fut.result()
            if res is None:
                continue
            try:
                out = proc.process_response(res, node)
            except errors.ERR_CONTINUE:
                break
            if out is not None:
                return out
    return None


def crypto_phase(dev, replicas, writers, ec_replicas, seed: int, build_dir: str, qctx: dict) -> dict:
    """The crypto layer on the card (the port of bftkv_tpu/crypto), each part
    counted: (a) collective signatures: the 93 writes' shares issued through
    Signer.issue_many with the dispatchers installed (K2 k=94 flushes, K1
    fault checks), combined against each writer's AUTH|PEER quorum from the
    quorum phase with the writer's own keyring, 1% of the entries forged,
    then verify_many of each writer's jobs against its quorum, with the
    verify memo reset (K1), and once more with the memo on; the verdicts
    are held to a host recount (at least suff valid signers in the clique); (b) a TPA round at n=64, k=43 (K2 k=188), a wrong
    password failing every server's MAC; (c) threshold DSA at n=64, k=22 on
    a 2048-bit p (calculate_r: one K2 k=188 launch); (d) threshold ECDSA at
    n=64, k=22 (each partial R one K5 launch at T=8, the combine one more);
    (e) threshold RSA (3, 4) at 2048 bits, which launches nothing; (f) a
    MessageSecurity bootstrap and session round trip between an RSA and a
    P-256 replica, the native tiers, the codec.  Every K1, K2 and K5 launch
    of the phase is held against its plain version, the rows of one kernel
    and context in one plain run."""
    from concurrent.futures import ThreadPoolExecutor

    from bftkv_tpu_torch import packet
    from bftkv_tpu_torch.crypto import auth, cert as certmod, ec, ecdsa, new_crypto, rsa
    from bftkv_tpu_torch.crypto import signature, sss, vcache
    from bftkv_tpu_torch.crypto.message import MessageSecurity
    from bftkv_tpu_torch.crypto.threshold import ThresholdAlgo
    from bftkv_tpu_torch.errors import ERR_AUTHENTICATION_FAILURE
    from bftkv_tpu_torch.crypto.threshold import dsa as tdsa
    from bftkv_tpu_torch.crypto.threshold import ecdsa as tecdsa
    from bftkv_tpu_torch.crypto.threshold import rsa as trsa
    from bftkv_tpu_torch.ops import cuda_ec, cuda_rns, dispatch, ec_rns
    from bftkv_tpu_torch.ops import rsa as rsa_ops

    os.environ.update(BFTKV_SHARD="off")
    t_phase = time.perf_counter()
    rng = random.Random(seed + 11)
    out = {}
    k1_calls, k2_calls, k5_calls = [], [], []  # (part, args) of every launch
    launch_names = ("verify_cuda", "pow_cuda")

    def keep(part, rec_rns, rec_ec=None):
        k1_calls.extend((part, a) for a in rec_rns.calls["verify_cuda"])
        k2_calls.extend((part, a) for a in rec_rns.calls["pow_cuda"])
        if rec_ec is not None:
            k5_calls.extend((part, a) for a in rec_ec.calls["scalar_mult_cuda"])

    keys = replicas + writers
    uni = qctx["universe"]
    certs = [i.cert for i in uni.servers + uni.users]
    check([c.id for c in certs] == [certmod.private_key_id(k) for k in keys],
          "the universe's certificates are not the replica and writer keys in order")
    writer_nodes, writer_quorums = qctx["writer_nodes"], qctx["writer_quorums"]
    clique = set(writer_quorums[0].membership_matrix()[1])

    # (a) collective signatures
    plan = {}  # signer index -> [tbs]
    tbs_of = [b"collective-write-%d-seed-%d" % (w, seed) for w in range(N_WRITES)]
    signers_of = []
    for w in range(N_WRITES):
        who = [N_REPLICAS + w % N_WRITERS] + [(7 * w + j) % N_REPLICAS for j in range(SUFF)]
        signers_of.append(who)
        for i in who:
            plan.setdefault(i, []).append(tbs_of[w])
    signers = {i: signature.Signer(keys[i], certs[i]) for i in plan}
    order = sorted(plan)
    issued = {}
    vd = dispatch.install(dispatch.VerifyDispatcher(device=dev))
    sd = dispatch.install_signer(dispatch.SignDispatcher(device=dev))
    try:
        with Recorder(cuda_rns, launch_names) as rec, Counted() as c_sign:
            t0 = time.perf_counter()
            run_threads(len(order), lambda t: issued.__setitem__(
                order[t], signers[order[t]].issue_many(plan[order[t]], include_cert=False)))
            sign_ms = (time.perf_counter() - t0) * 1e3
        keep("collective_sign", rec)
        n_shares = sum(len(v) for v in plan.values())
        check(n_shares == N_WRITES * (SUFF + 1), f"{n_shares} shares planned")
        check(c_sign.launches["pow"] >= 1 and c_sign.launches["verify"] >= 1,
              f"Signer.issue_many launched {c_sign.launches}")
        check(c_sign.snap.get("sign.device", 0) + c_sign.snap.get("sign.host", 0) == n_shares
              and c_sign.snap.get("sign.fault", 0) == 0,
              f"sign.device {c_sign.snap.get('sign.device')}, sign.host {c_sign.snap.get('sign.host')}, "
              f"sign.fault {c_sign.snap.get('sign.fault')}")
        pos = {i: 0 for i in plan}
        jobs = []
        entries_of = []
        for w in range(N_WRITES):
            crypt, qa = writer_nodes[w % N_WRITERS][1], writer_quorums[w % N_WRITERS]
            ss = None
            for i in signers_of[w]:
                share = issued[i][pos[i]]
                pos[i] += 1
                ss, _done = crypt.collective.combine(ss, share, qa, crypt.keyring)
            entries_of.append(signature.parse_entries(ss.data))
            jobs.append([tbs_of[w], ss])
        flat = [(w, j) for w in range(N_WRITES) for j in range(len(entries_of[w]))]
        forged = set(rng.sample(flat, len(flat) // 100))
        for w in range(N_WRITES):
            ents = [(sid, sig[:-1] + bytes([sig[-1] ^ 1]) if (w, j) in forged else sig)
                    for j, (sid, sig) in enumerate(entries_of[w])]
            jobs[w][1].data = signature.serialize_entries(ents)
            entries_of[w] = ents
        by_id = {c.id: keys[i] for i, c in enumerate(certs)}
        expect, stub = [], []
        for w in range(N_WRITES):
            valid = {sid for sid, sig in entries_of[w] if rsa.verify_host(tbs_of[w], sig, by_id[sid].public)}
            # The host recount: the write completes with at least suff valid
            # signers in the clique.  The earlier stub counted any suff valid
            # ids, the writer's own entry among them.
            expect.append(len(valid & clique) >= SUFF)
            stub.append(len(valid) >= SUFF)
        jobs = [tuple(j) for j in jobs]

        def verify_per_writer():
            errs = [None] * N_WRITES
            for wi in range(N_WRITERS):
                ws = [w for w in range(N_WRITES) if w % N_WRITERS == wi]
                crypt = writer_nodes[wi][1]
                for w, e in zip(ws, crypt.collective.verify_many([jobs[w] for w in ws], writer_quorums[wi],
                                                                 crypt.keyring)):
                    errs[w] = e
            return errs

        vcache.reset()  # the shares' own signatures seeded the memo (Signer.issue_many)
        with Recorder(cuda_rns, launch_names) as rec, Counted() as c_ver:
            t0 = time.perf_counter()
            errs = verify_per_writer()
            verify_ms = (time.perf_counter() - t0) * 1e3
        keep("collective_verify", rec)
        got = [e is None for e in errs]
        check(got == expect, f"verify_many verdicts differ from the host recount on "
              f"{sum(g != e for g, e in zip(got, expect))} of {N_WRITES} jobs")
        check(c_ver.launches["verify"] >= 1, f"verify_many launched {c_ver.launches}")
        check(c_ver.snap.get("verify.cache.hits", 0) == 0, "the counted verify_many hit the memo")
        with Recorder(cuda_rns, launch_names) as rec, Counted() as c_memo:
            t0 = time.perf_counter()
            errs2 = verify_per_writer()
            memo_ms = (time.perf_counter() - t0) * 1e3
        keep("collective_verify_memo", rec)
        check([e is None for e in errs2] == expect, "verify_many with the memo on changed a verdict")
    finally:
        dispatch.uninstall_all()
    out["collective"] = {
        "shares": n_shares, "forged_entries": len(forged), "jobs": N_WRITES,
        "jobs_sufficient": sum(expect), "jobs_sufficient_under_the_stub": sum(stub),
        "verdicts_changed_against_the_stub": sum(e != s_ for e, s_ in zip(expect, stub)),
        "sign_ms": sign_ms, "verify_many_ms": verify_ms,
        "verify_many_memo_ms": memo_ms, "sign_launches": dict(c_sign.launches),
        "sign_flushes": c_sign.snap.get("signdispatch.flushes"),
        "verify_launches": dict(c_ver.launches),
        "memo": {"hits": c_memo.snap.get("verify.cache.hits", 0),
                 "misses": c_memo.snap.get("verify.cache.misses", 0),
                 "launches": dict(c_memo.launches)},
    }
    print(f"crypto (a) collective: {n_shares} shares through Signer.issue_many in {sign_ms:.1f} ms "
          f"(K2 {c_sign.launches['pow']}, K1 fault checks {c_sign.launches['verify']}, "
          f"{c_sign.snap.get('signdispatch.flushes')} flushes); {len(forged)} entries forged, "
          f"{sum(expect)}/{N_WRITES} jobs sufficient against the writers' quorums ({sum(stub)} under the "
          f"earlier stub: {out['collective']['verdicts_changed_against_the_stub']} verdicts changed); "
          f"verify_many per writer {verify_ms:.1f} ms (memo reset, K1 "
          f"{c_ver.launches['verify']}); with the memo on {memo_ms:.1f} ms, hits "
          f"{out['collective']['memo']['hits']}, K1 {c_memo.launches['verify']}", flush=True)

    # (b) TPA at n=64, k=43: the params, then the three phases
    pw = b"smoke password %d" % seed
    with Recorder(cuda_rns, launch_names) as rec, Counted() as c_tpa:
        t0 = time.perf_counter()
        params = auth.generate_partial_auth_params(pw, N_REPLICAS, AUTH_K, device=dev)
        servers = {i: auth.AuthServer(params[i], b"proof-%d" % i, sleep=lambda _t: None, device=dev)
                   for i in range(N_REPLICAS)}
        client = auth.AuthClient(pw, N_REPLICAS, AUTH_K, device=dev)
        reqs = client.initiate(list(servers))
        for phase in range(3):
            nxt = None
            for nid, req in reqs.items():
                res, _done = servers[nid].make_response(phase, req)
                nxt = client.process_response(phase, res, nid)
                if nxt is not None:
                    break
            check(nxt is not None, f"TPA phase {phase} did not complete")
            reqs = nxt
        tpa_ms = (time.perf_counter() - t0) * 1e3
    keep("tpa", rec)
    check(all(v == b"proof-%d" % nid for nid, v in reqs.items()) and len(reqs) == AUTH_K,
          "TPA: the proofs did not decrypt")
    secret = sss.SSSProcess(N_REPLICAS, AUTH_K, auth.Q, [
        sss.Coordinate(s.params.x, s.params.y) for s in list(servers.values())[:AUTH_K]]).secret
    gs = pow(auth.pi_of(pw), secret, auth.P)
    check(client.get_cipher_key() == auth._hash(gs.to_bytes((gs.bit_length() + 7) // 8, "big"), pw),
          "TPA: the client's cipher key is not hash(g_pi^S, password)")
    check(c_tpa.launches["pow"] >= 3, f"TPA launched {c_tpa.launches}")
    with Recorder(cuda_rns, launch_names) as rec, Counted() as c_bad:
        bad = auth.AuthClient(b"wrong " + pw, N_REPLICAS, AUTH_K, device=dev)
        reqs = bad.initiate(list(servers))
        for phase in range(2):
            nxt = None
            for nid, req in reqs.items():
                nxt = bad.process_response(phase, servers[nid].make_response(phase, req)[0], nid)
                if nxt is not None:
                    break
            check(nxt is not None, f"TPA (wrong password) phase {phase} did not complete")
            reqs = nxt
        refused = 0
        for nid, ni in reqs.items():
            try:
                servers[nid].make_response(2, ni)
            except ERR_AUTHENTICATION_FAILURE:
                refused += 1
    keep("tpa_wrong_password", rec)
    check(refused == len(reqs) == AUTH_K, f"a wrong password passed {len(reqs) - refused} MAC checks")
    out["tpa"] = {"n": N_REPLICAS, "k": AUTH_K, "round_ms": tpa_ms, "launches": dict(c_tpa.launches),
                  "wrong_password_launches": dict(c_bad.launches), "wrong_password_refused": refused,
                  "k2_rows": [a[0].shape[0] for p, a in k2_calls if p == "tpa"]}
    print(f"crypto (b) TPA n={N_REPLICAS} k={AUTH_K}: round {tpa_ms:.1f} ms, K2 launches "
          f"{c_tpa.launches['pow']} at T={out['tpa']['k2_rows']}; secret recovered; a wrong password "
          f"refused by all {refused} servers (K2 {c_bad.launches['pow']})", flush=True)

    # (c), (d): threshold DSA and ECDSA at n=64, k=22 over the replicas'
    # message layers
    crypts = [new_crypto(k, c, device=dev) for k, c in zip(replicas, certs)]
    for cr in crypts:
        cr.keyring.register(certs[:N_REPLICAS])
    nodes = certs[:N_REPLICAS]
    dsa_key = _load_dsa_group(seed, build_dir)
    ec_key = tecdsa.generate(ec.P256, seed=seed + 12)
    results = {}
    with ThreadPoolExecutor(CRYPTO_WORKERS) as pool:
        for name, scheme, key in (("dsa", tdsa, dsa_key), ("ecdsa", tecdsa, ec_key)):
            servers = {c.id: scheme.new(cr, device=dev) for c, cr in zip(nodes, crypts)}
            client = scheme.new(crypts[0], device=dev)
            with Recorder(cuda_rns, launch_names) as rec, Recorder(cuda_ec, ("scalar_mult_cuda",)) as rec_e, \
                    Counted() as c_t:
                t0 = time.perf_counter()
                dealt, algo = client.distribute(key, nodes, CERT_K)
                shares = {n.id: s for n, s in zip(nodes, dealt)}
                tbs = b"threshold-%s-seed-%d" % (name.encode(), seed)
                proc = client.new_process(tbs, algo, "sha256")
                sig = _threshold_round(client, servers, shares, nodes, proc, pool)
                ms = (time.perf_counter() - t0) * 1e3
            keep(f"threshold_{name}", rec, rec_e)
            check(sig is not None, f"threshold {name}: no signature")
            results[name] = (sig, tbs, ms, dict(c_t.launches))
    sig, tbs, dsa_ms, dsa_launch = results["dsa"]
    size = 32
    r, s_ = int.from_bytes(sig[:size], "big"), int.from_bytes(sig[size:], "big")
    q = dsa_key.q
    m = int.from_bytes(hashlib.sha256(tbs).digest()[:size], "big")
    w_ = pow(s_, -1, q)
    check(0 < r < q and pow(dsa_key.g, m * w_ % q, dsa_key.p) * pow(dsa_key.y, r * w_ % q, dsa_key.p)
          % dsa_key.p % q == r, "threshold DSA: the signature fails the host DSA verify")
    check(dsa_launch["pow"] == 1, f"threshold DSA launched {dsa_launch}")
    sig, tbs, ecdsa_ms, ecdsa_launch = results["ecdsa"]
    x, y = ec.P256.scalar_base_mult(ec_key.d)
    check(ecdsa.verify_host(tbs, sig, ecdsa.ECPublicKey(x=x, y=y)),
          "threshold ECDSA: the signature fails ecdsa.verify_host")
    check(ecdsa_launch["ec_scalar_mult"] == 2 * CERT_K + 1, f"threshold ECDSA launched {ecdsa_launch}")
    k5_rows = sorted({a[0].shape[-1] for _p, a in k5_calls})
    out["threshold_dsa"] = {"n": N_REPLICAS, "k": CERT_K, "sign_ms": dsa_ms, "launches": dsa_launch}
    out["threshold_ecdsa"] = {"n": N_REPLICAS, "k": CERT_K, "sign_ms": ecdsa_ms, "launches": ecdsa_launch,
                              "k5_rows": k5_rows}
    print(f"crypto (c) threshold DSA n={N_REPLICAS} k={CERT_K} (2048-bit p): {dsa_ms:.1f} ms, launches "
          f"{dsa_launch}; (d) threshold ECDSA: {ecdsa_ms:.1f} ms, K5 launches "
          f"{ecdsa_launch['ec_scalar_mult']} at T={k5_rows}; both pass host verify", flush=True)

    # (e) threshold RSA (3, 4) at 2048 bits: fragments of 4092-8185 bits sign
    # on the host
    tkey = replicas[1]
    ctx = trsa.RSAThreshold(rng=random.Random(seed + 13).randrange, device=dev)
    tnodes = certs[:TRSA_N]
    limb_calls = []
    real_pb = rsa_ops.power_batch
    rsa_ops.power_batch = lambda *a, **kw: limb_calls.append(1) or real_pb(*a, **kw)
    try:
        with Counted() as c_r:
            t0 = time.perf_counter()
            tshares, _algo = ctx.distribute(tkey, tnodes, TRSA_K)
            tbs = b"threshold-rsa-seed-%d" % seed
            proc = ctx.new_process(tbs, ThresholdAlgo.RSA, "sha256")
            tsig = None
            for _ in range(10):
                target, req = proc.make_request()
                if req is None or tsig is not None:
                    break
                for i, node in enumerate(target[: TRSA_N - 1]):  # one server is down
                    res = ctx.sign(tshares[i], req, 0xC11E47, i)
                    if res is not None and proc.process_response(res, node) is not None:
                        tsig = proc.sig
                        break
            trsa_ms = (time.perf_counter() - t0) * 1e3
    finally:
        rsa_ops.power_batch = real_pb
    widths = [abs(f).bit_length() for sh in tshares for f in trsa._parse_partial_param(sh)[0].values()]
    check(tsig == rsa.sign(tbs, tkey) and rsa.verify_host(tbs, tsig, tkey.public),
          "threshold RSA: the combined signature fails host verify")
    check(c_r.launches["pow"] == 0 and not limb_calls,
          f"threshold RSA reached the device: {c_r.launches}, {len(limb_calls)} limb batches")
    out["threshold_rsa"] = {"n": TRSA_N, "k": TRSA_K, "key_bits": 2048, "sign_ms": trsa_ms,
                            "k2_launches": c_r.launches["pow"], "limb_batches": len(limb_calls),
                            "fragment_bits": [min(widths), max(widths)], "fragments": len(widths)}
    print(f"crypto (e) threshold RSA ({TRSA_K}, {TRSA_N}) 2048-bit: {trsa_ms:.1f} ms on the host, "
          f"{len(widths)} fragments of {min(widths)}-{max(widths)} bits; K2 launches 0, limb batches 0",
          flush=True)

    # (f) envelopes between an RSA and a P-256 replica, the native tiers,
    # the codec
    ek = ec_replicas[0]
    ec_cert = certmod.make_ec_certificate(ek.public, name="e0", uid="e0@smoke")
    certmod.sign_certificate(ec_cert, ek)
    m_rsa, m_ec = MessageSecurity(replicas[0], certs[0]), MessageSecurity(ek, ec_cert)
    tags = []
    for i in range(2):
        blob = m_rsa.encrypt([ec_cert], b"r2e-%d" % i, b"n%d" % i)
        pt, sender, nonce = m_ec.decrypt(blob)
        check((pt, nonce, sender.id) == (b"r2e-%d" % i, b"n%d" % i, certs[0].id), "RSA -> P-256 envelope")
        reply = m_ec.encrypt([certs[0]], b"e2r-%d" % i, b"m%d" % i)
        pt, sender, _ = m_rsa.decrypt(reply)
        check((pt, sender.id) == (b"e2r-%d" % i, ec_cert.id), "P-256 -> RSA envelope")
        tags.append((blob[0], reply[0]))
    # The bootstrap grants the pair's session: every later envelope, the
    # reply included, takes the session path.
    check(tags == [(1, 2), (2, 2)], f"envelope tags {tags}: expected one bootstrap, then sessions")
    nkey = replicas[2]
    msgs = [b"native-%d" % i for i in range(NATIVE_SIGNS)]
    t0 = time.perf_counter()
    native = [rsa.sign(m_, nkey) for m_ in msgs]
    native_ms = (time.perf_counter() - t0) * 1e3
    mm, rsa._MM = rsa._MM, None
    try:
        t0 = time.perf_counter()
        plain = [rsa.sign(m_, nkey) for m_ in msgs]
        pow_ms = (time.perf_counter() - t0) * 1e3
    finally:
        rsa._MM = mm
    check(native == plain, "crt_pow_d on the native tier differs from pow")
    pk = packet.Packet(variable=b"var", value=b"value" * 20, t=7,
                       sig=packet.SignaturePacket(data=b"s" * 64, cert=b"c" * 40),
                       ss=packet.SignaturePacket(completed=False, data=b"x" * 300), auth=b"auth")
    wire = pk.serialize()
    pure = packet._py_serialize(pk.variable, pk.value, pk.t, pk.sig, pk.ss, pk.auth)
    check(wire == pure and packet.parse(wire) == packet._py_parse(pure) == pk,
          "the native and pure codecs differ on one packet")
    out["envelopes"] = {"tags": tags, "native_modexp": mm is not None, "native_codec": packet._C is not None,
                        "rsa_sign_native_ms": native_ms / NATIVE_SIGNS, "rsa_sign_pow_ms": pow_ms / NATIVE_SIGNS}
    print(f"crypto (f) envelopes RSA <-> P-256 (ECIES): bootstrap then session both ways; native modexp "
          f"{'loaded' if mm is not None else 'NOT loaded'}, native codec "
          f"{'loaded' if packet._C is not None else 'NOT loaded'}; {NATIVE_SIGNS} rsa.sign "
          f"{native_ms / NATIVE_SIGNS:.3f} ms each through crt_pow_d, {pow_ms / NATIVE_SIGNS:.3f} ms with pow; "
          f"one packet equal through both codecs", flush=True)

    # Every launch against its plain version.
    hold_rns_calls(k1_calls, k2_calls, "crypto phase")
    if k5_calls:
        eng = k5_calls[0][1][2]
        kern = torch.cat([cuda_ec.scalar_mult_cuda(*a) for _p, a in k5_calls], dim=-1)
        plain = ec_rns._scalar_mult(eng, torch.cat([a[0] for _p, a in k5_calls], dim=-1).contiguous(),
                                    torch.cat([a[1] for _p, a in k5_calls], dim=1).contiguous())
        check(torch.equal(kern, plain), "K5 differs from its plain version on the crypto phase's operands")
    torch.cuda.synchronize()
    held = {"K1": len(k1_calls), "K2": len(k2_calls), "K5": len(k5_calls)}
    print(f"crypto: every launch of the phase equal to its plain version ({held}); phase "
          f"{time.perf_counter() - t_phase:.1f} s on {nvidia_smi('name,power.limit')}", flush=True)

    # A record for each (kernel, context, rows) shape of the phase
    records = rns_shape_records(k1_calls, k2_calls, "crypto layer")
    for (t,), v in sorted(_shapes(k5_calls, lambda a: (a[0].shape[-1],)).items()):
        rec = ec_record(v["args"], sum(v["parts"].values()), 20, phase_launches=v["parts"],
                        **cuda_ec.kernel_attrs()["ec_scalar_mult"])
        rec["name"] += f" (T={t}, crypto layer)"
        records.append(rec)
    out["records"] = records
    out["held_against_plain"] = held
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# -- the protocol phase --------------------------------------------------------------


def _free_port_block(n: int) -> int:
    """The first of ``n`` consecutive localhost ports this process can bind,
    probed from a random start in [20000, 32000): below the OS's ephemeral
    range."""
    import socket

    rng = random.Random()
    for _ in range(200):
        base = rng.randrange(20000, 32000 - n)
        held = []
        try:
            for port in range(base, base + n):
                sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                held.append(sock)
                sock.bind(("127.0.0.1", port))
        except OSError:
            continue
        finally:
            for sock in held:
                sock.close()
        return base
    fail(f"no {n} consecutive free localhost ports")


class _RecordingTransport:
    """A client transport that only records what the client multicasts."""

    def __init__(self):
        self.sent = []

    def multicast(self, cmd, peers, data, cb):
        self.sent.append((cmd, len(peers)))


def rns_main_shape_records(k1_calls, k2_calls, label: str) -> list:
    """A kernel record for each (kernel, context) of a phase, timed on the
    operands of the row count that carries most of its rows; every shape's
    launches beside."""
    from bftkv_tpu_torch.ops import cuda_rns

    attrs = cuda_rns.kernel_attrs()
    records = []
    for which, calls, name, src in (("verify", k1_calls, "K1 rns_verify_kernel", "bftkv_tpu/ops/pallas_rns.py:517"),
                                    ("pow", k2_calls, "K2 rns_pow_kernel", "bftkv_tpu/ops/pallas_rns.py:403")):
        by_k = {}
        for _part, a in calls:
            by_k.setdefault(a[4].k, []).append(a)
        for k, group in sorted(by_k.items()):
            by_rows = {}
            for a in group:
                by_rows.setdefault(a[0].shape[0], []).append(a)
            t, args = max(by_rows.items(), key=lambda kv: (len(kv[1]) * kv[0], kv[0]))
            records.append(rns_record(
                f"{name} (k={k}, T={t}, {label})", which, src, args[0], len(args),
                10 if which == "pow" else 20, 1 if which == "pow" else 2,
                launches_all_shapes=len(group),
                launches_by_rows={str(r): len(v) for r, v in sorted(by_rows.items())},
                **attrs[which]))
    return records


def protocol_phase(dev, uni, replicas, writers, storage_keys, seed: int) -> dict:
    """The transport, protocol and sync layers (the port of
    bftkv_tpu/transport/, protocol/, sync/, crypto/presession.py and
    api.py) at the headline's deployment, bench.py's
    bench_cluster_batch(64, 8, 4, 1024, 2): (a) the quorum phase's universe
    as 64 port Servers and 8 storage nodes on MemStorage over one
    LoopbackNet, every node on the card, and its 4 writers as port
    Clients, with VerifyDispatcher(max_batch=4096) and
    SignDispatcher(max_batch=4096) installed on the card; the fan-out
    _inline_fanout_ok picks must be threaded; a warm write_many of 64
    items; (b) anti-entropy: one storage node misses single writes'
    back-fill and a batched round (the transport.send drop failpoint),
    then its SyncDaemon's repair_once() and a pull round; its digest root
    must equal the other storage nodes' and it must serve every write;
    (c) the counted rounds: the 4 writers released together, each
    write_many of 1024 items of 1 KiB from --seed, then a read_many of
    every key the round wrote; every acknowledged write must read back
    with its value; (d) revoke-on-read on the card: a read's response map
    with 170 colluders among 512 signers, whose batched tally is one
    tally.equivocation_pairs launch whose mask must equal the host scan,
    and exactly the colluders revoked; (e) bench.py's cluster_4_http
    shape: 4 servers and 4 storage nodes on TrHTTP at probed localhost
    ports, a home written by the port's topology opened by
    api.open_client(device=); a write, read, write_many and read_many read
    back.  Every K1 and K2 launch of the counted rounds is held against
    its plain version."""
    import shutil
    import tempfile

    import numpy as np

    from bftkv_tpu_torch import api, packet, topology
    from bftkv_tpu_torch import transport as tp
    from bftkv_tpu_torch.crypto import new_crypto
    from bftkv_tpu_torch.crypto import signature as sigmod
    from bftkv_tpu_torch.faults import failpoint as fp
    from bftkv_tpu_torch.graph import Graph
    from bftkv_tpu_torch.ops import cuda_rns, dispatch, tally
    from bftkv_tpu_torch.protocol.client import Client, _SignedValue
    from bftkv_tpu_torch.protocol.server import Server
    from bftkv_tpu_torch.quorum.wotqs import WotQS
    from bftkv_tpu_torch.storage.memkv import MemStorage
    from bftkv_tpu_torch.sync import SyncDaemon
    from bftkv_tpu_torch.transport.http import TrHTTP
    from bftkv_tpu_torch.transport.loopback import LoopbackNet, TrLoopback

    os.environ.update(BFTKV_SHARD="off")
    t_phase = time.perf_counter()
    out = {"cuts": []}
    vrng = random.Random(seed ^ 0x51C0)

    def value():
        return vrng.randbytes(PROTO_VALUE_BYTES)

    # (a) the cluster
    t0 = time.perf_counter()
    net = LoopbackNet()
    servers = {}
    for ident in uni.servers + uni.storage_nodes:
        g, crypt, qs = topology.make_node(ident, uni.view_of(ident), device=dev)
        srv = Server(g, qs, TrLoopback(crypt, net), crypt, MemStorage(), device=dev)
        srv.start()
        servers[ident.name] = srv
    clients = []
    for ident in uni.users:
        g, crypt, qs = topology.make_node(ident, uni.view_of(ident), device=dev)
        tr = TrLoopback(crypt, net)
        tr.link_id = ident.name
        clients.append(Client(g, qs, tr, crypt, device=dev))
    setup_ms = (time.perf_counter() - t0) * 1e3
    check(all(s.device == dev for s in servers.values()) and all(c.device == dev for c in clients),
          "a node of the protocol cluster is not on the card")
    storage = [servers[i.name] for i in uni.storage_nodes]
    dispatch.install(dispatch.VerifyDispatcher(max_batch=PROTO_DISPATCH_BATCH, device=dev))
    dispatch.install_signer(dispatch.SignDispatcher(max_batch=PROTO_DISPATCH_BATCH, device=dev))
    try:
        fanout = "inline" if tp._inline_fanout_ok() else "threaded"
        check(dev.type != "cuda" or fanout == "threaded",
              f"the fan-out is {fanout} with the card's dispatchers installed")
        warm_s = []
        for w in range(2):  # cold (sessions, calibration), then warm
            items = [(b"bench/warm/%d/%d" % (w, i), value()) for i in range(PROTO_WARM)]
            t0 = time.perf_counter()
            errs = clients[0].write_many(items)
            warm_s.append(time.perf_counter() - t0)
            check(errs == [None] * len(items), f"warm write_many: {[e for e in errs if e][:1]}")
            check(clients[0].read_many([x for x, _ in items]) == [v for _, v in items],
                  "a warm write does not read back")
        for c in clients:
            c.drain_tails()
        out["cluster"] = {"servers": len(uni.servers), "storage": len(uni.storage_nodes),
                          "writers": len(clients), "setup_ms": setup_ms, "fanout": fanout,
                          "warm_write_many_ms": [t * 1e3 for t in warm_s]}
        print(f"protocol (a) cluster: {len(uni.servers)} servers + {len(uni.storage_nodes)} storage nodes "
              f"on MemStorage over one LoopbackNet and {len(clients)} clients, every node on {dev}, in "
              f"{setup_ms:.1f} ms; fan-out {fanout}; warm write_many of {PROTO_WARM} "
              f"{warm_s[0] * 1e3:.1f} ms cold, {warm_s[1] * 1e3:.1f} ms warm", flush=True)

        # (b) anti-entropy: a storage node misses writes, then repairs and pulls
        victim = storage[-1]
        peers = storage[:-1]
        singles = [(b"ae/single/%d" % i, value()) for i in range(PROTO_MISSED_SINGLE)]
        batch = [(b"ae/batch/%d" % i, value()) for i in range(PROTO_MISSED)]
        fp.arm(seed)
        fp.registry.add("transport.send", "drop", rule_id="missed",
                        match={"cmd": lambda c: c in ("write", "batch_write"),
                               "dst": fp.link_of(victim.self_node.address)})
        try:
            for x, v in singles:
                clients[1].write(x, v)
            errs = clients[1].write_many(batch)
            clients[1].drain_tails()
        finally:
            fp.disarm()
        check(errs == [None] * len(batch), f"the missed round failed: {[e for e in errs if e][:1]}")
        root = lambda s: s._sync_tree().root()
        check(root(victim) != root(peers[0]), "the storage node did not miss the writes")
        daemon = SyncDaemon(victim, interval=999, rng=random.Random(seed))
        t0 = time.perf_counter()
        repaired = daemon.repair_once()
        repair_ms = (time.perf_counter() - t0) * 1e3
        pulls = []
        t0 = time.perf_counter()
        for _ in range(3):
            pulls.append(daemon.run_round())
            if root(victim) == root(peers[0]):
                break
        pull_ms = (time.perf_counter() - t0) * 1e3
        roots = {s.self_node.name: root(s).hex() for s in storage}
        check(len(set(roots.values())) == 1, f"digest roots differ after repair and pull: {roots}")
        for x, v in singles + batch:
            p = packet.parse(victim.storage.read(x))
            check(p.value == v and p.ss is not None and p.ss.completed,
                  f"{victim.self_node.name} does not serve the certified {x!r}")
        out["anti_entropy"] = {"node": victim.self_node.name, "missed_single": len(singles),
                               "missed_batch": len(batch), "repair_once": repaired, "repair_ms": repair_ms,
                               "pull_rounds": pulls, "pull_ms": pull_ms, "root": roots[victim.self_node.name]}
        print(f"protocol (b) anti-entropy: {victim.self_node.name} missed {len(singles)} single writes' "
              f"back-fill and a {len(batch)}-item round; repair_once {repaired} in {repair_ms:.1f} ms, then "
              f"{len(pulls)} pull round(s) {pulls} in {pull_ms:.1f} ms; its digest root equals the other "
              f"{len(peers)} storage nodes' and it serves every write certified", flush=True)

        # (c) the counted rounds
        # Rounds are cut first (after each round, below); the batch only where
        # the warm write projects a single round past the whole budget.
        n_batch, n_rounds = PROTO_BATCH, PROTO_ROUNDS
        per_item = max(warm_s) / PROTO_WARM * len(clients)  # all writers share one host
        while n_batch > PROTO_WARM and per_item * n_batch > PROTO_BUDGET_S:
            n_batch //= 2
        if n_batch != PROTO_BATCH:
            out["cuts"].append(f"batch {PROTO_BATCH} -> {n_batch}: the warm write projected "
                               f"{per_item * PROTO_BATCH:.0f} s a round against a {PROTO_BUDGET_S:.0f} s budget")
        values = {(ci, r): [value() for _ in range(n_batch)] for ci in range(len(clients)) for r in range(n_rounds)}
        keys = lambda ci, r: [b"bench/%d/%d/%d" % (ci, r, i) for i in range(n_batch)]
        errors = []

        def together(fn):
            """``fn(ci)`` on every writer's thread, released together; wall s."""
            start = threading.Barrier(len(clients) + 1)

            def body(ci):
                start.wait()
                try:
                    fn(ci)
                except Exception as e:  # surfaced below: the phase fails
                    errors.append(e)

            ths = [threading.Thread(target=body, args=(ci,)) for ci in range(len(clients))]
            for th in ths:
                th.start()
            start.wait()
            t0 = time.perf_counter()
            for th in ths:
                th.join()
            return time.perf_counter() - t0

        def write_round(r):
            def fn(ci):
                errs = clients[ci].write_many(list(zip(keys(ci, r), values[(ci, r)])))
                bad = [e for e in errs if e is not None]
                if bad:
                    raise RuntimeError(f"writer {ci} round {r}: {len(bad)} writes failed, first {bad[0]!r}")
            return fn

        def read_round(r):
            def fn(ci):
                got = clients[ci].read_many(keys(ci, r))
                bad = [i for i, (g, v) in enumerate(zip(got, values[(ci, r)])) if g != v]
                if bad:
                    raise RuntimeError(f"writer {ci} round {r}: {len(bad)} acknowledged writes do not read "
                                       f"back, first {keys(ci, r)[bad[0]]!r} -> {got[bad[0]]!r:.80}")
            return fn

        launch_names = ("verify_cuda", "pow_cuda")
        write_s, read_s = [], []
        with Recorder(cuda_rns, launch_names) as rec, Counted() as c_run:
            for r in range(n_rounds):
                write_s.append(together(write_round(r)))
                check(not errors, f"round {r}: {errors[:1]}")
                read_s.append(together(read_round(r)))
                check(not errors, f"round {r} read-back: {errors[:1]}")
                spent = sum(write_s) + sum(read_s)
                if r + 1 < n_rounds and spent / (r + 1) * (r + 2) > PROTO_BUDGET_S:
                    out["cuts"].append(f"rounds {n_rounds} -> {r + 1}: {spent:.1f} s for {r + 1} round(s) "
                                       f"against a {PROTO_BUDGET_S:.0f} s budget")
                    n_rounds = r + 1
                    break
            for c in clients:
                c.drain_tails()
        snap, launches = c_run.snap, c_run.launches
        k1_calls = [("rounds", a) for a in rec.calls["verify_cuda"]]
        k2_calls = [("rounds", a) for a in rec.calls["pow_cuda"]]
        check(dev.type != "cuda" or (launches["verify"] >= 1 and launches["pow"] >= 1),
              f"the counted rounds launched {launches}")
        check(len(k1_calls) == launches["verify"] and len(k2_calls) == launches["pow"],
              f"recorded launches {len(k1_calls)}, {len(k2_calls)} differ from the counts {launches}")
        n_writes = len(clients) * n_rounds * n_batch
        rows = lambda calls: sum(a[0].shape[0] for _p, a in calls)
        timer = lambda name: {k: snap.get(f"{name}.{k}") for k in ("count", "sum", "p50", "p99")}
        out["rounds"] = {
            "writers": len(clients), "batch": n_batch, "rounds": n_rounds, "value_bytes": PROTO_VALUE_BYTES,
            "writes": n_writes, "reads": n_writes,
            "signed_writes_per_sec_64replica_batched": n_writes / sum(write_s),
            "reads_per_sec": n_writes / sum(read_s),
            "write_round_ms": [t * 1e3 for t in write_s], "read_round_ms": [t * 1e3 for t in read_s],
            "client.write_many.phase_time": timer("client.write_many.phase_time"),
            "client.write_many.phase_self_sign": timer("client.write_many.phase_self_sign"),
            "client.write_many.phase_sign": timer("client.write_many.phase_sign"),
            "client.write_many.phase_verify": timer("client.write_many.phase_verify"),
            "client.write_many.phase_write": timer("client.write_many.phase_write"),
            "server.batch_sign.handler": timer("server.batch_sign.handler"),
            "server.batch_write.handler": timer("server.batch_write.handler"),
            "k1_launches": launches["verify"], "k1_rows": rows(k1_calls),
            "k2_launches": launches["pow"], "k2_rows": rows(k2_calls),
            "verify_device": snap.get("verify.device", 0), "verify_host": snap.get("verify.host", 0),
            "sign_device": snap.get("sign.device", 0), "sign_host": snap.get("sign.host", 0),
            "dispatch_flushes": snap.get("dispatch.flushes", 0), "dispatch_verifies": snap.get("dispatch.verifies", 0),
            "signdispatch_flushes": snap.get("signdispatch.flushes", 0),
            "verify_cache_hits": snap.get("verify.cache.hits", 0),
            "verify_cache_misses": snap.get("verify.cache.misses", 0),
        }
        ro = out["rounds"]
        per = lambda n, d: n / d if d else 0.0
        ms = lambda t: "n/a" if t["sum"] is None else f"{t['sum'] * 1e3:.1f} ms over {t['count']}"
        print(f"protocol (c) rounds: {len(clients)} writers x {n_rounds} rounds x {n_batch} items of "
              f"{PROTO_VALUE_BYTES} B: signed_writes_per_sec_64replica_batched "
              f"{ro['signed_writes_per_sec_64replica_batched']:.2f}, reads/s {ro['reads_per_sec']:.2f}; "
              f"write rounds {[round(t, 1) for t in ro['write_round_ms']]} ms, read rounds "
              f"{[round(t, 1) for t in ro['read_round_ms']]} ms; every acknowledged write read back", flush=True)
        print(f"protocol (c) write_many phases (sum over chunks): time {ms(ro['client.write_many.phase_time'])}, "
              f"self-sign {ms(ro['client.write_many.phase_self_sign'])}, sign {ms(ro['client.write_many.phase_sign'])}, "
              f"verify {ms(ro['client.write_many.phase_verify'])}, write {ms(ro['client.write_many.phase_write'])}; "
              f"server.batch_sign.handler {ms(ro['server.batch_sign.handler'])}, "
              f"server.batch_write.handler {ms(ro['server.batch_write.handler'])}", flush=True)
        print(f"protocol (c) launches: K1 {ro['k1_launches']} ({per(ro['k1_rows'], ro['k1_launches']):.1f} rows a "
              f"launch), K2 {ro['k2_launches']} ({per(ro['k2_rows'], ro['k2_launches']):.1f} rows a launch); "
              f"verify.device {ro['verify_device']} host {ro['verify_host']}, sign.device {ro['sign_device']} "
              f"host {ro['sign_host']}; flushes verify {ro['dispatch_flushes']} sign {ro['signdispatch_flushes']}; "
              f"verify.cache hits {ro['verify_cache_hits']} misses {ro['verify_cache_misses']}", flush=True)

        # (d) revoke-on-read on the card
        honest_a = list(range(REVOKE_UNIVERSE // 2))
        honest_b = list(range(REVOKE_UNIVERSE // 2, REVOKE_UNIVERSE - REVOKE_BYZ))
        colluders = list(range(REVOKE_UNIVERSE - REVOKE_BYZ, REVOKE_UNIVERSE))
        base_id = 1 << 40

        class _Ref:
            def __init__(self, i):
                self.id, self.name, self.address, self.active = base_id + i, f"r{i:03d}", "", True

        def ss_for(signers):
            return packet.SignaturePacket(
                type=packet.SIGNATURE_TYPE_NATIVE, version=1, completed=True,
                data=sigmod.serialize_entries([(base_id + i, b"sig") for i in signers]))

        reps = [_Ref(i) for i in range(REVOKE_UNIVERSE)]
        ss_a, ss_b = ss_for(honest_a + colluders), ss_for(honest_b + colluders)
        m = {7: {b"value-A": [_SignedValue(reps[i], None, ss_a, b"pA") for i in honest_a + colluders],
                 b"value-B": [_SignedValue(reps[i], None, ss_b, b"pB") for i in honest_b + colluders]}}
        user = uni.users[0]
        g = Graph()
        g.set_self_nodes([user.cert])
        reader = Client(g, WotQS(g), _RecordingTransport(), new_crypto(user.key, user.cert, device=dev),
                        device=dev)
        entries = len(honest_a) + len(honest_b) + 2 * len(colluders)
        check(entries >= reader.BATCH_REVOKE_THRESHOLD,
              f"{entries} signer entries do not reach BATCH_REVOKE_THRESHOLD {reader.BATCH_REVOKE_THRESHOLD}")
        tallied = []
        real_pairs = tally.equivocation_pairs

        def counted_pairs(sets, **kw):
            mask = real_pairs(sets, **kw)
            tallied.append((np.asarray(sets), mask))
            return mask

        tally.equivocation_pairs = counted_pairs
        try:
            t0 = time.perf_counter()
            reader._revoke_on_read(m)
            revoke_ms = (time.perf_counter() - t0) * 1e3
        finally:
            tally.equivocation_pairs = real_pairs
        check(len(tallied) == 1, f"revoke-on-read made {len(tallied)} tally launches, not one")
        sets, mask = tallied[0]
        check(mask.device.type == dev.type, f"the equivocation tally ran on {mask.device}")
        # The host scan of the reference client (client.py:2085-2093).
        seen, scan = {}, set()
        rows_ = [{sid for sv in svl for sid in sigmod.signers(sv.ss)} for svl in m[7].values()]
        for round_no, row in enumerate(rows_):
            for sid in row:
                prev = seen.get(sid)
                if prev is None:
                    seen[sid] = round_no
                elif prev != round_no:
                    scan.add(sid)
        ids = sorted(set().union(*rows_))
        on_card = {ids[i] for i in np.nonzero(mask.cpu().numpy())[0]}
        check(on_card == scan, f"the card's equivocation mask names {len(on_card)} signers, the host scan {len(scan)}")
        check(set(g.revoked) == {base_id + i for i in colluders},
              f"revoke-on-read revoked {len(g.revoked)}, not exactly the {REVOKE_BYZ} colluders")
        out["revoke_on_read"] = {"universe": REVOKE_UNIVERSE, "colluders": REVOKE_BYZ, "signer_entries": entries,
                                 "tally_launches": len(tallied), "mask_shape": list(sets.shape),
                                 "revoked": len(g.revoked), "ms": revoke_ms}
        print(f"protocol (d) revoke-on-read: {entries} signer entries (universe {REVOKE_UNIVERSE}, "
              f"{REVOKE_BYZ} colluders) -> one equivocation_pairs launch on {mask.device} at {list(sets.shape)}, "
              f"mask equal to the host scan; exactly the {REVOKE_BYZ} colluders revoked in {revoke_ms:.1f} ms",
              flush=True)

        # (e) HTTP and api.py: bench.py's cluster_4_http shape
        tmp = tempfile.mkdtemp(prefix="smoke-http-")
        http_servers = []
        try:
            base = _free_port_block(HTTP_SERVERS + HTTP_STORAGE)
            huni = topology.build_universe(
                HTTP_SERVERS, 1, HTTP_STORAGE, scheme="http", base_port=base,
                rw_base_port=base + HTTP_SERVERS, bits=2048,
                keys=replicas[:HTTP_SERVERS] + storage_keys[:HTTP_STORAGE] + writers[:1])
            t0 = time.perf_counter()
            for ident in huni.servers + huni.storage_nodes:
                g2, crypt, qs = topology.make_node(ident, huni.view_of(ident), device=dev)
                srv = Server(g2, qs, TrHTTP(crypt), crypt, MemStorage(), device=dev)
                srv.start()
                http_servers.append(srv)
            home = os.path.join(tmp, huni.users[0].name)
            topology.save_home(home, huni.users[0], huni.view_of(huni.users[0]))
            cli = api.open_client(home, device=dev)
            check(cli.client.device == dev and isinstance(cli.client.tr, TrHTTP),
                  "open_client did not build an HTTP client on the card")
            x, v = b"http/one", value()
            cli.write(x, v)
            check(cli.read(x) == v, "the HTTP write does not read back")
            hitems = [(b"http/many/%d" % i, value()) for i in range(HTTP_ITEMS)]
            check(cli.write_many(hitems) == [None] * HTTP_ITEMS, "the HTTP write_many failed")
            check(cli.read_many([k for k, _ in hitems]) == [v for _, v in hitems],
                  "the HTTP write_many does not read back")
            cli.client.drain_tails()
            http_ms = (time.perf_counter() - t0) * 1e3
        finally:
            for srv in http_servers:
                srv.tr.stop()
            shutil.rmtree(tmp, ignore_errors=True)
        out["http_api"] = {"servers": HTTP_SERVERS, "storage": HTTP_STORAGE, "first_port": base,
                           "items": HTTP_ITEMS, "ms": http_ms}
        print(f"protocol (e) HTTP: {HTTP_SERVERS} + {HTTP_STORAGE} servers on TrHTTP at 127.0.0.1:{base}-"
              f"{base + HTTP_SERVERS + HTTP_STORAGE - 1}; api.open_client(device={dev}) on a port home: a "
              f"write, read, write_many and read_many of {HTTP_ITEMS} read back in {http_ms:.1f} ms", flush=True)
    finally:
        dispatch.uninstall_all()
        for srv in servers.values():
            srv.tr.stop()

    hold_rns_calls(k1_calls, k2_calls, "protocol phase's counted rounds")
    torch.cuda.synchronize()
    held = {"K1": len(k1_calls), "K2": len(k2_calls)}
    out["records"] = rns_main_shape_records(k1_calls, k2_calls, "protocol rounds")
    out["held_against_plain"] = held
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"protocol: every launch of the counted rounds equal to its plain version ({held}); cuts "
          f"{out['cuts'] or 'none'}; phase {out['phase_s']:.1f} s on {nvidia_smi('name,power.limit')}", flush=True)
    return out


# -- the deploy phase --------------------------------------------------------------


def _wait_ports(ports, procs, timeout: float, what: str) -> None:
    """Until every localhost port accepts a connection; fails if one of
    ``procs`` exits first or the time runs out."""
    import socket

    deadline = time.monotonic() + timeout
    left = list(ports)
    while left:
        with socket.socket() as sock:
            sock.settimeout(0.5)
            try:
                sock.connect(("127.0.0.1", left[0]))
                left.pop(0)
                continue
            except OSError:
                pass
        dead = [p for p in procs if p.poll() is not None]
        if dead:
            fail(f"{what}: {len(dead)} process(es) exited before serving, first {dead[0].args}")
        check(time.monotonic() < deadline, f"{what}: port {left[0]} not up in {timeout:.0f} s")
        time.sleep(0.25)


def _host_used_bytes() -> int:
    """The host's memory in use: MemTotal - MemAvailable (/proc/meminfo).
    Its growth over the fleet's start is the fleet's footprint (the
    daemons' VmRSS counts torch's shared library pages once a process,
    some 4.6 GB each)."""
    with open("/proc/meminfo") as f:
        kb = {l.split(":")[0]: int(l.split()[1]) for l in f}
    return (kb["MemTotal"] - kb["MemAvailable"]) * 1024


def _cpu_seconds(pids) -> float:
    """User + system CPU seconds of ``pids`` so far (/proc/<pid>/stat)."""
    tick = os.sysconf("SC_CLK_TCK")
    total = 0.0
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            total += (int(fields[11]) + int(fields[12])) / tick
        except (OSError, IndexError, ValueError):
            pass
    return total


def _card_pids() -> list:
    """nvidia-smi's compute apps, the processes holding a context on a card
    (pids as the NVIDIA kernel driver sees them: another pid namespace's where the card
    is shared into a container)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout
    return [int(x) for x in out.split() if x.strip().isdigit()]


def _cuda_initialized(api_ports) -> list:
    """The ``device.cuda_initialized`` gauge of each API's /metrics."""
    return [m.get("device.cuda_initialized") for m in _daemon_metrics(api_ports)]


class _CardSampler:
    """Polls nvidia-smi's compute apps every few seconds while a block runs:
    the pids seen and the most at once."""

    def __init__(self, every: float = 3.0):
        self.every, self.pids, self.samples, self.most = every, set(), 0, 0
        self._stop = threading.Event()

    def __enter__(self):
        def loop():
            while True:
                seen = _card_pids()
                self.pids |= set(seen)
                self.most = max(self.most, len(seen))
                self.samples += 1
                if self._stop.wait(self.every):
                    return

        self._th = threading.Thread(target=loop, daemon=True)
        self._th.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._th.join(timeout=90)


def _daemon_metrics(api_ports) -> list:
    """Each daemon's /metrics JSON snapshot."""
    import urllib.request

    out = []
    for port in api_ports:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics?format=json", timeout=60) as res:
            out.append(json.loads(res.read()))
    return out


def _recorded_main(out: str, module: str, argv: list) -> int:
    """``main(argv)`` of the port's command ``module`` (``bftrw``, the chaos
    nemesis) with its K1 and K2 launches counted and their operands kept:
    written to ``out`` (torch.save) on the host, beside the time.monotonic()
    at which main returned (one clock for every process of the host) and
    the process's counters.  A command runs as
    ``python -c "import chip_smoke; ..." OUT MODULE <arguments>``."""
    import importlib

    from bftkv_tpu_torch.ops import cuda_rns, rns

    main_ = importlib.import_module(module).main
    with Recorder(cuda_rns, ("verify_cuda", "pow_cuda")) as rec, Counted() as run:
        try:
            rc = main_(argv)
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
    done = time.monotonic()
    consts = {id(cn): key[:2] for key, cn in rns._consts_cache.items()}
    calls = {name: [(a.cpu(), b.cpu(), idx.cpu(), tuple(u.cpu() for u in ukey), consts[id(cn)])
                    for a, b, idx, ukey, cn in recorded] for name, recorded in rec.calls.items()}
    torch.save({"rc": rc, "done": done, "launches": run.launches, "calls": calls,
                "snap": run.snap}, out)
    return rc


#: How a recorded command runs: ``[sys.executable, "-c", RECORDED, OUT, MODULE, *argv]``.
RECORDED = "import sys, chip_smoke; sys.exit(chip_smoke._recorded_main(sys.argv[1], sys.argv[2], sys.argv[3:]))"


def _recorded_calls(path: str, part: str, dev) -> tuple[dict, list, list]:
    """A :func:`_recorded_main` file: (its record, its K1 calls, its K2
    calls), the operands back on ``dev`` as (part, args) pairs."""
    from bftkv_tpu_torch.ops import rns

    got = torch.load(path)
    k1, k2 = ([(part, (a.to(dev), b.to(dev), idx.to(dev), tuple(u.to(dev) for u in ukey), rns.consts(*c, dev)))
               for a, b, idx, ukey, c in got["calls"][name]] for name in ("verify_cuda", "pow_cuda"))
    return got, k1, k2


def _together(argvs, logs, env) -> tuple[float, float, list]:
    """The commands started together; the time.monotonic() of the first
    start, wall seconds from it to the last exit, and each one's
    (returncode, stdout, stderr)."""
    procs, files = [], []
    t0 = time.monotonic()
    for argv, log in zip(argvs, logs):
        out, err = open(log + ".out", "wb+"), open(log + ".err", "wb+")
        files.append((out, err))
        procs.append(subprocess.Popen(argv, stdout=out, stderr=err, env=env))
    for p in procs:
        p.wait()
    wall = time.monotonic() - t0
    results = []
    for p, (out, err) in zip(procs, files):
        out.seek(0)
        err.seek(0)
        results.append((p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    return t0, wall, results


def _get_json(url: str):
    import urllib.request

    with urllib.request.urlopen(url, timeout=120) as res:
        return json.loads(res.read())


def _maps_libcuda(pid: int) -> bool:
    """Whether process ``pid`` has libcuda mapped: a process holding a
    context on a card has."""
    with open(f"/proc/{pid}/maps") as f:
        return any("libcuda.so" in line for line in f)


#: A fleet one-shot in a process that reports, after cmd.fleet's main,
#: whether it imported torch and initialised CUDA (a JSON line last).
FLEET_ONESHOT = ("import json, sys\n"
                 "from bftkv_tpu_torch.cmd import fleet\n"
                 "rc = fleet.main(sys.argv[1:])\n"
                 "t = sys.modules.get('torch')\n"
                 "print(json.dumps({'torch': t is not None, 'cuda': bool(t is not None and t.cuda.is_initialized())}))\n"
                 "sys.exit(rc)\n")


def fleet_health(api_base: int, n_nodes: int, fleet_port: int, collector, sidecar_stats: int,
                 blackbox: str, env: dict) -> dict:
    """Deploy (f), the fleet health plane (the port of bftkv_tpu/obs/ and
    cmd/fleet.py) over the deployed fleet: DEPLOY_FLEET_WRITES writes through
    a daemon's client API (the user's home), then run_cluster's collector
    process (``--fleet``, ``--recorder``) must list all 72 members up, every
    shard's f-budget full and those writes in the merged write SLO (the
    daemons' fixed-bucket latency keys); a demand bundle lands under the
    recorder's directory; the collector process has no libcuda mapped
    and is no compute app of the card; ``cmd.fleet`` one-shot over the 72
    APIs exits 0 in a process that never imports torch; a collector in this
    process times DEPLOY_FLEET_SCRAPES scrapes of the 72 APIs, and one over
    the 72, the gateway and the sidecar's stats port sees the sidecar as a
    ``role=sidecar`` member whose capacity row holds its dispatchers'
    occupancy on the card."""
    import urllib.request

    from bftkv_tpu_torch.obs import FleetCollector, HTTPSource

    out = {}
    t0 = time.perf_counter()
    for i in range(DEPLOY_FLEET_WRITES):
        req = urllib.request.Request(f"http://127.0.0.1:{api_base}/write/deploy/fleet/{i}",
                                     data=b"slo-%d" % i, method="POST")
        with urllib.request.urlopen(req, timeout=DEPLOY_RPC_TIMEOUT_S) as res:
            check(res.status == 200, f"a write through the daemon API answered {res.status}")
    out["api_writes_ms"] = (time.perf_counter() - t0) * 1e3
    with urllib.request.urlopen(f"http://127.0.0.1:{api_base + 1}/read/deploy/fleet/0",
                                timeout=DEPLOY_RPC_TIMEOUT_S) as res:
        check(res.read() == b"slo-0", "a write through the daemon API does not read back")

    url = f"http://127.0.0.1:{fleet_port}"
    t0 = time.perf_counter()
    while True:
        doc = _get_json(url + "/fleet")
        writes = sum(sd["slo"].get("write", {}).get("count", 0) for sd in doc.get("shards", {}).values())
        if doc.get("fleet", {}).get("up") == n_nodes and writes >= DEPLOY_FLEET_WRITES:
            break
        check(collector.poll() is None, f"the fleet collector exited {collector.returncode}")
        check(time.perf_counter() - t0 < DEPLOY_FLEET_WAIT_S,
              f"/fleet after {DEPLOY_FLEET_WAIT_S:.0f} s: {doc.get('fleet')}, write SLO count {writes}")
        time.sleep(0.5)
    wait_s = time.perf_counter() - t0
    fl = doc["fleet"]
    check(fl["daemons"] == n_nodes and not fl.get("down") and not fl.get("unseated"), f"/fleet: {fl}")
    budgets = {sh: sd["f_budget"] for sh, sd in doc["shards"].items()}
    check(all(b["remaining"] == b["f"] and not b["down"] and not b["storage_down"] for b in budgets.values()),
          f"a shard's f-budget is not full: {budgets}")
    slo = {sh: sd["slo"]["write"] for sh, sd in doc["shards"].items() if "write" in sd["slo"]}
    with urllib.request.urlopen(url + "/fleet?format=prometheus", timeout=120) as res:
        prom = res.read().decode()
    check("bftkv_fleet_write_latency_bucket" in prom, "/fleet's Prometheus text has no write latency histogram")
    req = urllib.request.Request(url + "/fleet/bundle", data=b"", method="POST")
    with urllib.request.urlopen(req, timeout=120) as res:
        bundle = json.loads(res.read())["bundle"]
    check(bundle.startswith(blackbox) and os.path.exists(os.path.join(bundle, "manifest.json")),
          f"the demand bundle {bundle} is not under {blackbox}")
    apps = _card_pids()
    check(not _maps_libcuda(collector.pid) and collector.pid not in apps,
          f"the fleet collector (pid {collector.pid}) has libcuda mapped; the card's apps {apps}")

    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", FLEET_ONESHOT, "--api-base", str(api_base), "--count",
                        str(n_nodes), "--json"], env=env, capture_output=True, timeout=600)
    oneshot_s = time.perf_counter() - t0
    text = r.stdout.decode()
    check(r.returncode == 0 and "\n{" in text, f"cmd.fleet one-shot exited {r.returncode}: {r.stderr[-600:]!r}")
    one, state = json.loads(text[: text.rindex("\n{")]), json.loads(text[text.rindex("\n{"):])
    check(one["fleet"]["up"] == n_nodes, f"cmd.fleet one-shot: {one['fleet']}")
    check(state == {"torch": False, "cuda": False}, f"the cmd.fleet process: {state}")

    coll = FleetCollector([HTTPSource(f"127.0.0.1:{api_base + i}") for i in range(n_nodes)])
    scrapes = []
    for _ in range(DEPLOY_FLEET_SCRAPES):
        t0 = time.perf_counter()
        d72 = coll.scrape_once()
        scrapes.append(time.perf_counter() - t0)
    check(d72["fleet"]["up"] == n_nodes, f"this process's collector: {d72['fleet']}")
    sources = [HTTPSource(f"127.0.0.1:{p}") for p in range(api_base, sidecar_stats + 1)]
    d74 = FleetCollector(sources).scrape_once()
    sc = d74.get("sidecars") or {}
    check(len(sc) == 1 and all(m["status"] == "up" for m in sc.values()), f"the sidecar member: {sc}")
    (sc_name,) = sc
    sc_disp = ((d74.get("capacity") or {}).get("members", {}).get(sc_name) or {}).get("dispatch") or {}
    check(bool(sc_disp.get("dispatchers")) and sc_disp["utilization"] > 0,
          f"the sidecar's capacity row has no dispatch occupancy: {sc_disp}")
    check(d74["fleet"]["up"] == n_nodes + 2, f"the 72 daemons, the gateway and the sidecar: {d74['fleet']}")
    out.update(
        members=fl["daemons"], up=fl["up"], wait_s=wait_s, shards=len(budgets), budgets=budgets,
        write_slo={sh: {k: v for k, v in w.items() if k != "buckets"} for sh, w in slo.items()},
        anomalies=len(doc.get("anomalies", [])),
        traces={k: v for k, v in doc.get("traces", {}).items() if k in ("traces", "stitched")},
        bundle=os.path.basename(bundle), collector_pid=collector.pid, oneshot_s=oneshot_s,
        oneshot_process=state, scrape_s_72=scrapes,
        sidecar_member={"name": sc_name, "dispatch": sc_disp,
                        "device": (sc[sc_name].get("device_plane") or {}).get("device")},
    )
    print(f"deploy (f) fleet: run_cluster --fleet --recorder: /fleet lists {fl['up']}/{fl['daemons']} members up "
          f"{wait_s:.1f} s after {DEPLOY_FLEET_WRITES} writes through a daemon's API "
          f"({out['api_writes_ms']:.1f} ms), {len(budgets)} shard(s) at a full f-budget "
          f"{[(b['remaining'], b['f']) for b in budgets.values()]}, write SLO "
          f"{ {sh: (w['count'], w.get('p99_le_s')) for sh, w in slo.items()} } (count, p99 bound s); demand "
          f"bundle {os.path.basename(bundle)}; the collector process never mapped libcuda; cmd.fleet one-shot over "
          f"{n_nodes} APIs exit 0 in {oneshot_s:.1f} s, torch never imported; this process's collector scrapes "
          f"the {n_nodes} APIs in {', '.join(f'{t * 1e3:.1f}' for t in scrapes)} ms; over {len(sources)} "
          f"(the gateway and the sidecar's stats) it sees {sc_name} up on {out['sidecar_member']['device']}, "
          f"dispatch utilization {sc_disp['utilization']}", flush=True)
    return out


def deploy_phase(dev, replicas, writers, storage_keys, seed: int) -> dict:
    """The process surfaces (the port of bftkv_tpu/cmd/, gateway/, workload/,
    obs/source.py, obs/profiler.py): the headline's round, bench.py's
    bench_cluster_batch(64, 8, 4, 1024, 2), as the deployment runs it, one
    process per replica.  (a) the universe of 64 servers, 8 storage nodes,
    the 4 writers and a gateway on localhost HTTP at probed ports, its homes
    written by genkeys' own body; the port's crypto sidecar served in this
    process on the card (admission sized for 72 tenants); the 72 daemons
    spawned by run_cluster.spawn(sidecar=...), each with --device on the
    card; spawn time and the fleet's resident memory.  (b) the counted
    round: 4 bftrw processes (--device on the card) released together, each
    a writemany of DEPLOY_BATCH items of 1 KiB (512 seeded bytes, hex),
    then a readmany of every key; every acknowledged write must read back;
    signed writes/s, reads/s, the sidecar's K1 and K2 launches and rows,
    the daemons' handler p50s; no daemon falls back to local crypto, the
    sidecar sheds nothing, no daemon holds a context on the card (by its
    own gauge, and no daemon pid among nvidia-smi's compute apps); the
    writers run bftrw's main under _recorded_main, and every K1 and K2
    launch of the round, the sidecar's and the writers' own, is held
    against its plain version.  (c) run_gateway with --sidecar in front of the fleet: 64 keys
    read twice through a GatewayClient, the second pass from the gateway's
    certified cache.  (d) workload.driver.run_multiprocess, the write_heavy
    preset, 2 worker processes at 120 ops/s for 10 s (a probe run sizes a
    cut).  (e) run_cluster.shutdown: every daemon exits 0."""
    import shutil
    import tempfile
    import types
    import urllib.request

    from bftkv_tpu_torch import flags, topology
    from bftkv_tpu_torch.admission import AdmissionQueue
    from bftkv_tpu_torch.cmd import genkeys, run_cluster
    from bftkv_tpu_torch.cmd import verify_sidecar as vs
    from bftkv_tpu_torch.crypto import rsa
    from bftkv_tpu_torch.gateway import GatewayClient, GatewayPeer
    from bftkv_tpu_torch.ops import cuda_rns
    from bftkv_tpu_torch.protocol.client import Client
    from bftkv_tpu_torch.transport.http import TrHTTP
    from bftkv_tpu_torch.workload import WorkloadSpec, run_multiprocess

    t_phase = time.perf_counter()
    out = {"cuts": []}
    root = tempfile.mkdtemp(prefix="smoke-deploy-")
    logs = os.path.join(root, "logs")
    os.makedirs(logs)
    # Every process of the phase imports the package from this checkout.
    here = os.path.dirname(os.path.abspath(__file__))
    os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (here, os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, BFTKV_RPC_TIMEOUT=str(DEPLOY_RPC_TIMEOUT_S))
    procs, fleet, gw_proc, srv = [], [], None, None
    try:
        # (a) homes, the sidecar, the fleet
        t0 = time.perf_counter()
        n, e, d, p, q = _gen_key(seed * 1000 + N_REPLICAS + N_WRITERS + N_STORAGE)
        gw_key = rsa.PrivateKey(n=n, e=e, d=d, p=p, q=q)
        n_nodes = N_REPLICAS + N_STORAGE
        # The nodes and the gateway, their APIs, the sidecar's stats port
        # and the fleet collector's /fleet.
        base = _free_port_block(2 * (n_nodes + 1) + 2)
        api_base = base + n_nodes + 1
        sidecar_stats = api_base + n_nodes + 1
        fleet_port = sidecar_stats + 1
        blackbox = os.path.join(root, "blackbox")
        uni = topology.build_universe(
            N_REPLICAS, N_WRITERS, N_STORAGE, scheme="http", base_port=base,
            rw_base_port=base + N_REPLICAS, gw_base_port=base + n_nodes, n_gateways=1,
            keys=replicas + storage_keys + writers + [gw_key])
        homes = genkeys.write_homes(uni, os.path.join(root, "keys"))
        homes_s = time.perf_counter() - t0
        node_names = [i.name for i in uni.servers + uni.storage_nodes]
        check(run_cluster.server_homes(os.path.join(root, "keys")) == sorted(homes[n] for n in node_names)
              and [h for h in run_cluster.gateway_homes(os.path.join(root, "keys"))] == [homes["gw01"]],
              "run_cluster does not see the 72 server homes and the gateway home")
        sock = "unix:" + os.path.join(root, "sidecar.sock")
        prev = flags.raw("BFTKV_DISPATCH_RECAL_S")
        os.environ.update(BFTKV_DISPATCH_RECAL_S="0")
        try:
            srv, _thread = vs.serve(sock, max_batch=VERIFY_FLUSH, device=dev,
                                    admission=AdmissionQueue(**DEPLOY_ADMISSION, metric="sidecar.shed"),
                                    stats=f"127.0.0.1:{sidecar_stats}")
        finally:
            if prev is None:
                os.environ.pop("BFTKV_DISPATCH_RECAL_S")
            else:
                os.environ.update(BFTKV_DISPATCH_RECAL_S=prev)
        svc = srv.service
        import glob

        from bftkv_tpu_torch import native

        built = lambda: {p: os.stat(p).st_mtime_ns for p in glob.glob(os.path.join(native.BUILD_DIR, "*.so"))}
        libs = built()
        check(len(libs) >= 2, f"the native libraries are not built before the fleet starts: {sorted(libs)}")
        host_before = _host_used_bytes()
        t0 = time.perf_counter()
        # The fleet health plane rides beside the daemons: the collector
        # process (python -m bftkv_tpu_torch.cmd.fleet --listen, host only)
        # with its flight recorder.
        procs = run_cluster.spawn(
            [homes[n] for n in node_names], os.path.join(root, "dbs"), storage="mem",
            api_base=api_base, sidecar=sock, rpc_timeout=DEPLOY_RPC_TIMEOUT_S, extra_env=env,
            device=str(dev), log_dir=logs, fleet=fleet_port, fleet_interval=DEPLOY_FLEET_INTERVAL_S,
            recorder=blackbox, client_home=homes[uni.users[0].name])
        fleet = [p for p in procs if "bftkv_tpu_torch.cmd.bftkv" in p.args]
        collector = [p for p in procs if "bftkv_tpu_torch.cmd.fleet" in p.args]
        check(len(fleet) == n_nodes and len(collector) == 1,
              f"run_cluster.spawn started {len(fleet)} daemons and {len(collector)} collectors")
        api_ports = [api_base + i for i in range(n_nodes)]
        # The gateway starts beside the fleet, as run_cluster starts it, so
        # its ports are bound before the round's connections take local
        # ports from the same range.
        gw_api = api_base + n_nodes
        gw_port = int(uni.gateway_addrs["gw01"].rsplit(":", 1)[1])
        with open(os.path.join(logs, "gw01.log"), "wb") as glog:
            gw_proc = subprocess.Popen(
                [sys.executable, "-m", "bftkv_tpu_torch.cmd.run_gateway", "--home", homes["gw01"],
                 "--sidecar", sock, "--device", str(dev), "--api", f"127.0.0.1:{gw_api}",
                 "--rpc-timeout", str(DEPLOY_RPC_TIMEOUT_S)],
                env=env, stdout=glog, stderr=subprocess.STDOUT)
        _wait_ports(list(range(base, base + n_nodes)) + api_ports + [fleet_port], procs, DEPLOY_START_S,
                    "the fleet")
        spawn_s = time.perf_counter() - t0
        _wait_ports([gw_port, gw_api], [gw_proc], DEPLOY_START_S, "the gateway")
        gw_start_s = time.perf_counter() - t0
        daemon_pids = [p.pid for p in fleet]
        host_delta = _host_used_bytes() - host_before
        check(built() == libs,
              "a daemon rebuilt a native library")
        # No daemon holds a context on the card: by its own account (the
        # gauge on its /metrics) and by the NVIDIA driver's (nvidia-smi's compute
        # apps: no daemon pid, and no more processes than this one).
        inited = _cuda_initialized(api_ports)
        check(inited == [0] * n_nodes, f"daemons report CUDA initialised: {inited}")
        apps = _card_pids()
        check(not set(apps) & set(daemon_pids),
              f"a daemon pid among the card's compute apps at start: {apps} (daemons {daemon_pids[:4]}...)")
        out["fleet"] = {"servers": N_REPLICAS, "storage": N_STORAGE, "processes": len(fleet),
                        "storage_engine": "mem", "homes_s": homes_s, "spawn_s": spawn_s,
                        "host_memory_bytes": host_delta, "host_memory_bytes_per_daemon": host_delta / len(fleet),
                        "card_apps_at_start": apps, "cpus": os.cpu_count(),
                        "admission": DEPLOY_ADMISSION, "first_port": base, "api_base": api_base}
        print(f"deploy (a) fleet: {N_REPLICAS} servers + {N_STORAGE} storage daemons (python -m "
              f"bftkv_tpu_torch.cmd.bftkv --device {dev} --sidecar unix:...) up in {spawn_s:.1f} s on "
              f"{os.cpu_count()} cpus; host memory in use +{host_delta / 2**30:.2f} GiB "
              f"({host_delta / len(fleet) / 2**20:.0f} MiB a daemon), homes {homes_s:.1f} s; the sidecar in this process on {dev}, admission {DEPLOY_ADMISSION}; every "
              f"daemon's device.cuda_initialized 0, the card's compute apps {apps}; "
              f"{nvidia_smi('name,power.limit')}", flush=True)

        # (b) the counted round: 4 bftrw writers, then their readmany
        vrng = random.Random(seed ^ 0xDE910)
        user_homes = [homes[u.name] for u in uni.users]

        def bftrw(i, *argv):
            return [sys.executable, "-m", "bftkv_tpu_torch.cmd.bftrw", "--home", user_homes[i],
                    "--device", str(dev), *argv]

        def write_files(tag, n):
            items = []
            for w in range(len(user_homes)):
                kv = [(f"deploy/{tag}/{w}/{i}", vrng.randbytes(512).hex()) for i in range(n)]
                path = os.path.join(root, f"{tag}-{w}.txt")
                with open(path, "w") as f:
                    f.write("".join(f"{k}={v}\n" for k, v in kv))
                items.append((path, kv))
            return items

        # The counted round's writers run bftrw's main under
        # _recorded_main: their own launches on the card (the client's
        # collective-signature verifies and self-signs) are counted and
        # held against their plain versions with the sidecar's.
        writer_runs = []

        def together(tag, op, argvs, recorded):
            logs_ = [os.path.join(logs, f"{tag}-{op}-{w}") for w in range(len(argvs))]
            if not recorded:
                return _together(argvs, logs_, env)[1:]
            outs = [log + ".pt" for log in logs_]
            t0, _wall, res = _together([[sys.executable, "-c", RECORDED, out, "bftkv_tpu_torch.cmd.bftrw",
                                         *argv[3:]] for argv, out in zip(argvs, outs)], logs_, env)
            done = 0.0
            for w, (out, (rc, _o, err)) in enumerate(zip(outs, res)):
                check(rc == 0 and os.path.exists(out), f"writer {w} ({tag} {op}): rc {rc}, {err[-400:]!r}")
                got, k1, k2 = _recorded_calls(out, f"writer {w} {op}", dev)
                writer_runs.append((got["launches"], k1, k2))
                done = max(done, got["done"])
                os.remove(out)
            return done - t0, res

        def writemany(tag, files, recorded=False):
            wall, res = together(tag, "write", [bftrw(w, "writemany", "--file", path)
                                                for w, (path, _kv) in enumerate(files)], recorded)
            for w, ((rc, _o, err), (_p, kv)) in enumerate(zip(res, files)):
                check(rc == 0 and f"{len(kv)}/{len(kv)} written".encode() in err,
                      f"writer {w} ({tag}): rc {rc}, {err[-400:]!r}")
            return wall

        def readmany(tag, files, recorded=False):
            wall, res = together(tag, "read", [bftrw(w, "readmany", *(k for k, _v in kv))
                                               for w, (_p, kv) in enumerate(files)], recorded)
            for w, ((rc, o, err), (_p, kv)) in enumerate(zip(res, files)):
                got = dict(line.split("=", 1) for line in o.decode().splitlines())
                bad = [k for k, v in kv if got.get(k) != v]
                check(rc == 0 and not bad, f"writer {w} ({tag}): rc {rc}, {len(bad)} acknowledged writes do "
                      f"not read back, first {bad[:1]}; {err[-300:]!r}")
            return wall

        warm = write_files("warm", DEPLOY_WARM)
        warm_s = writemany("warm", warm)
        warm_read_s = readmany("warm", warm)
        print(f"deploy (b) warm: {len(warm)} writers x writemany of {DEPLOY_WARM} in {warm_s:.1f} s, readmany "
              f"{warm_read_s:.1f} s", flush=True)
        per_item = max(warm_s - warm_read_s, 1e-3) / DEPLOY_WARM
        n_batch = DEPLOY_BATCH
        while n_batch > DEPLOY_WARM and warm_read_s + per_item * n_batch > DEPLOY_BUDGET_S:
            n_batch //= 2
        if n_batch != DEPLOY_BATCH:
            out["cuts"].append(f"batch {DEPLOY_BATCH} -> {n_batch}: the warm writemany of {DEPLOY_WARM} "
                               f"({warm_s:.1f} s, start-up and read {warm_read_s:.1f} s) projected "
                               f"{warm_read_s + per_item * DEPLOY_BATCH:.0f} s against a "
                               f"{DEPLOY_BUDGET_S:.0f} s budget")
        files = write_files("round", n_batch)
        cpu0 = (time.process_time(), _cpu_seconds(daemon_pids))
        with Recorder(cuda_rns, ("verify_cuda", "pow_cuda")) as rec, Counted() as c_run, \
                _CardSampler() as sampler:
            write_s = writemany("round", files, recorded=True)
            cpu1 = (time.process_time(), _cpu_seconds(daemon_pids))
            load = os.getloadavg()
            read_s = readmany("round", files, recorded=True)
        snap, launches = c_run.snap, c_run.launches
        k1_calls = [("round", a) for a in rec.calls["verify_cuda"]]
        k2_calls = [("round", a) for a in rec.calls["pow_cuda"]]
        w_k1 = [c for _l, k1, _k2 in writer_runs for c in k1]
        w_k2 = [c for _l, _k1, k2 in writer_runs for c in k2]
        w_launches = {name: sum(l[name] for l, _k1, _k2 in writer_runs) for name in launches}
        dm = _daemon_metrics(api_ports)
        falls = {k: sum(m.get(k, 0) for m in dm) for k in
                 ("verify.remote_fallback", "sign.remote_fallback", "verify.remote_shed", "sign.remote_shed",
                  "verify.remote_breaker_open", "crypto.sidecar.dishonest", "sign.remote_refused")}
        sheds = {k: v for k, v in snap.items() if k.startswith("sidecar.shed")}
        p50s = lambda name: sorted(m[f"{name}.p50"] for m in dm if f"{name}.p50" in m)
        bs, bw = p50s("server.batch_sign.handler"), p50s("server.batch_write.handler")
        n_writes = len(files) * n_batch
        rows = lambda calls: sum(a[0].shape[0] for _p, a in calls)
        mid = lambda xs: {"median": statistics.median(xs), "max": xs[-1], "daemons": len(xs)} if xs else None
        out["round"] = {
            "writers": len(files), "batch": n_batch, "value_bytes": 1024, "writes": n_writes,
            "signed_writes_per_sec_64replica_deployed": n_writes / write_s,
            "reads_per_sec": n_writes / read_s, "write_round_ms": write_s * 1e3, "read_round_ms": read_s * 1e3,
            "warm_writemany_ms": warm_s * 1e3, "warm_readmany_ms": warm_read_s * 1e3,
            # CPU seconds over the write round: the sidecar's process (this
            # one) and the 72 daemons together, beside the round's wall
            # time on os.cpu_count() cpus, and the load average after it.
            "cpu_s_sidecar_process": cpu1[0] - cpu0[0], "cpu_s_daemons": cpu1[1] - cpu0[1],
            "loadavg_1m_after_writes": load[0],
            "k1_launches": launches["verify"], "k1_rows": rows(k1_calls),
            "k2_launches": launches["pow"], "k2_rows": rows(k2_calls),
            # The writers' own launches (bftrw on the card, 4 write and 4
            # read processes), counted and recorded in each process.
            "writer_launches": w_launches, "writer_k1_rows": rows(w_k1), "writer_k2_rows": rows(w_k2),
            "sidecar_verify_items": snap.get("sidecar.items{op=verify}", 0),
            "sidecar_sign_items": snap.get("sidecar.items{op=sign}", 0),
            "sidecar_requests": {k: v for k, v in snap.items() if k.startswith("sidecar.ops")},
            "sidecar_verify_flush_s": {k: snap.get(f"dispatch.flush.seconds.{k}") for k in ("count", "sum", "p50", "p99")},
            "verify_device": snap.get("verify.device", 0), "verify_host": snap.get("verify.host", 0),
            "sign_device": snap.get("sign.device", 0), "sign_host": snap.get("sign.host", 0),
            "server.batch_sign.handler_p50_s": mid(bs), "server.batch_write.handler_p50_s": mid(bw),
            "daemon_remote": {k: sum(m.get(k, 0) for m in dm) for k in ("verify.remote", "sign.remote")},
            "fallbacks_and_sheds": {**falls, "sidecar.shed": svc.admission.shed},
            "card_apps": sorted(sampler.pids), "card_apps_most": sampler.most, "card_samples": sampler.samples,
        }
        ro = out["round"]
        per = lambda n, d: n / d if d else 0.0
        ms = lambda xs: f"{statistics.median(xs) * 1e3:.1f} ms" if xs else "n/a"
        print(f"deploy (b) round: {len(files)} bftrw writers x writemany of {n_batch} items of 1 KiB through the "
              f"{len(fleet)} daemons: signed writes/s {ro['signed_writes_per_sec_64replica_deployed']:.2f} (round "
              f"{write_s:.1f} s, process start included), reads/s {ro['reads_per_sec']:.2f} (readmany "
              f"{read_s:.1f} s); every acknowledged write read back; CPU over the write round: the sidecar's "
              f"process {ro['cpu_s_sidecar_process']:.1f} s, the daemons {ro['cpu_s_daemons']:.1f} s, on "
              f"{os.cpu_count()} cpus (load {load[0]:.1f})", flush=True)
        print(f"deploy (b) sidecar: K1 {ro['k1_launches']} launches ({per(ro['k1_rows'], ro['k1_launches']):.1f} "
              f"rows a launch), K2 {ro['k2_launches']} ({per(ro['k2_rows'], ro['k2_launches']):.1f} rows a launch); "
              f"verify items {ro['sidecar_verify_items']}, sign items {ro['sidecar_sign_items']}, verify flushes "
              f"{ro['sidecar_verify_flush_s']}; verify.device {ro['verify_device']} host {ro['verify_host']}, "
              f"sign.device {ro['sign_device']} host {ro['sign_host']}; daemons' handler p50 (median over "
              f"daemons) batch_sign {ms(bs)}, batch_write {ms(bw)}; fallbacks and sheds "
              f"{ro['fallbacks_and_sheds']}; the card's compute apps {sorted(sampler.pids)}, at most "
              f"{sampler.most} at once over {sampler.samples} samples", flush=True)
        print(f"deploy (b) writers: the bftrw processes' own launches on {dev} {w_launches} (K1 {ro['writer_k1_rows']} "
              f"rows, K2 {ro['writer_k2_rows']} rows), recorded in each process", flush=True)
        check(launches["verify"] >= 1 and launches["pow"] >= 1, f"the sidecar launched {launches} in the round")
        check(len(k1_calls) == launches["verify"] and len(k2_calls) == launches["pow"],
              f"recorded launches {len(k1_calls)}, {len(k2_calls)} differ from the counts {launches}")
        check(len(w_k1) == w_launches["verify"] and len(w_k2) == w_launches["pow"]
              and not any(v for name, v in w_launches.items() if name not in ("verify", "pow")),
              f"the writers' recorded launches {len(w_k1)}, {len(w_k2)} differ from their counts {w_launches}")
        inited = [m.get("device.cuda_initialized") for m in dm]
        check(inited == [0] * n_nodes, f"daemons report CUDA initialised after the round: {inited}")
        check(not sampler.pids & set(daemon_pids),
              f"a daemon pid among the card's compute apps during the round: {sorted(sampler.pids)}")
        check(not any(falls.values()), f"the daemons fell back to local crypto: {falls}")
        check(svc.admission.shed == 0 and not any(sheds.values()),
              f"the sidecar shed {svc.admission.shed} ({sheds})")
        check(bs and bw, "no daemon timed a BATCH_SIGN or BATCH_WRITE handler")

        # (c) the gateway, through the sidecar
        g, cr, q = topology.load_home(user_homes[0], device=dev)
        gwc = GatewayClient(Client(g, q, TrHTTP(cr), cr, device=dev),
                            [GatewayPeer(cr.keyring.get(uni.gateways[0].id), uni.gateway_addrs["gw01"])])
        want = files[0][1][:DEPLOY_GW_READS]
        passes = []
        for _ in range(2):
            t0 = time.perf_counter()
            got = [gwc.read(k.encode()) for k, _v in want]
            passes.append(time.perf_counter() - t0)
            check(got == [v.encode() for _k, v in want], "a gateway read differs from what was written")
        with urllib.request.urlopen(f"http://127.0.0.1:{gw_api}/info", timeout=60) as res:
            gst = json.loads(res.read())["gateway"]
        check(gst["misses"] >= DEPLOY_GW_READS and gst["hits"] >= DEPLOY_GW_READS and gst["verify_fail"] == 0,
              f"the second pass did not hit the gateway's certified cache: {gst}")
        check(_cuda_initialized([gw_api]) == [0] and gw_proc.pid not in _card_pids(),
              "the gateway holds a context on the card")
        out["gateway"] = {"reads": DEPLOY_GW_READS, "passes_ms": [t * 1e3 for t in passes],
                          "start_s": gw_start_s, "hits": gst["hits"], "misses": gst["misses"]}
        print(f"deploy (c) gateway: run_gateway --sidecar on {dev} up {gw_start_s:.1f} s after the fleet's start; "
              f"{DEPLOY_GW_READS} keys "
              f"read twice through a GatewayClient, {passes[0] * 1e3:.1f} ms (certified fills) then "
              f"{passes[1] * 1e3:.1f} ms (cache: hits {gst['hits']}, misses {gst['misses']}); every value "
              f"equal to the write", flush=True)

        # (d) the workload driver: 2 worker processes over HTTP
        spec = WorkloadSpec.preset("write_heavy", rate=DEPLOY_WL_RATE, duration_s=DEPLOY_WL_DURATION_S,
                                   seed=seed % 100000)
        cl = types.SimpleNamespace(universe=uni)
        wl_dir = os.path.join(root, "workload")
        os.makedirs(wl_dir)
        probe = run_multiprocess(spec, cl, wl_dir, procs=DEPLOY_WL_PROCS, device=str(dev),
                                 max_ops_per_worker=DEPLOY_WL_PROBE_OPS, timeout_s=300.0)
        check(probe["errors"] == 0, f"the workload probe: {probe['error_samples']}")
        per_op = probe["elapsed_s"] / DEPLOY_WL_PROBE_OPS
        full = -(-spec.total_ops() // DEPLOY_WL_PROCS)
        cap = None
        if per_op * full > DEPLOY_WL_BUDGET_S:
            cap = max(DEPLOY_WL_PROBE_OPS, int(DEPLOY_WL_BUDGET_S / per_op))
            out["cuts"].append(f"workload ops a worker {full} -> {cap}: the probe's {per_op * 1e3:.0f} ms an op "
                               f"projected {per_op * full:.0f} s against a {DEPLOY_WL_BUDGET_S:.0f} s budget")
        rep = run_multiprocess(spec, cl, wl_dir, procs=DEPLOY_WL_PROCS, device=str(dev),
                               max_ops_per_worker=cap, timeout_s=600.0)
        check(rep["errors"] == 0 and rep["worker_reports"] == DEPLOY_WL_PROCS,
              f"the workload run: {rep['errors']} errors, {rep['worker_reports']} reports, {rep['error_samples']}")
        out["workload"] = {k: rep[k] for k in ("spec", "preset", "workers", "offered_rate_per_sec", "offered_ops",
                                                "achieved_rate_per_sec", "elapsed_s", "p50_offered_s",
                                                "p99_offered_s", "mean_offered_s", "ops", "errors", "backlog")}
        out["workload"].update(scheduled_ops=spec.total_ops(), probe_ms_per_op=per_op * 1e3, ops_cap_per_worker=cap)
        print(f"deploy (d) workload: write_heavy, {DEPLOY_WL_PROCS} worker processes on {dev}, offered "
              f"{rep['offered_rate_per_sec']:.1f} ops/s for {DEPLOY_WL_DURATION_S:g} s ({spec.total_ops()} ops "
              f"scheduled, {rep['offered_ops']} run), achieved {rep['achieved_rate_per_sec']} ops/s, p50 "
              f"{rep['p50_offered_s']} s, p99 {rep['p99_offered_s']} s from the scheduled start, backlog "
              f"{rep['backlog']}, ops {rep['ops']}, errors 0", flush=True)

        # (f) the fleet health plane over the deployed fleet
        out["health"] = fleet_health(api_base, n_nodes, fleet_port, collector[0], sidecar_stats, blackbox, env)
    finally:
        # (e) teardown: the gateway, the fleet, the sidecar
        if gw_proc is not None:
            run_cluster.shutdown([gw_proc], timeout=30.0)
        t0 = time.perf_counter()
        # A daemon still running 5 s before the deadline dumps its threads'
        # stacks into its log (SIGUSR1) before shutdown kills it.
        dump = threading.Timer(DEPLOY_STOP_S - 5.0, lambda: [p.send_signal(signal.SIGUSR1)
                                                             for p in fleet if p.poll() is None])
        dump.start()
        run_cluster.shutdown(procs, timeout=DEPLOY_STOP_S)
        dump.cancel()
        stop_s = time.perf_counter() - t0
        if srv is not None:
            srv.service.stop()
            srv.shutdown()
            srv.server_close()
            if srv.stats_httpd is not None:
                srv.stats_httpd.shutdown()
    rcs = [p.returncode for p in fleet]
    if not rcs or any(rc != 0 for rc in rcs):
        stuck = [(n, rc) for n, rc in zip(node_names, rcs) if rc != 0]
        tails = {n: open(os.path.join(logs, n + ".log"), "rb").read()[-3000:] for n, _rc in stuck[:2]}
        fail(f"{len(stuck)} daemon(s) did not exit 0 within {DEPLOY_STOP_S:.0f} s of SIGTERM: {stuck[:8]}; "
             f"log tails {tails}")
    check(gw_proc.returncode == 0, f"the gateway exited {gw_proc.returncode}")
    stopped = sum(1 for n in node_names
                  if open(os.path.join(logs, n + ".log"), "rb").read().rstrip().endswith(b"bftkv: stopped"))
    check(stopped == len(fleet), f"{len(fleet) - stopped} daemon(s) did not log a clean stop")
    revs = [n for n in node_names if os.path.exists(os.path.join(root, "dbs", n + ".rev"))]
    out["teardown"] = {"stop_s": stop_s, "exit_codes": sorted(set(rcs)), "revocation_lists": len(revs)}
    print(f"deploy (e) teardown: {len(fleet)} daemons and the gateway exited 0 in {stop_s:.1f} s, each logging a "
          f"clean stop; revocation lists written: {len(revs)} (nothing was revoked)", flush=True)
    hold_rns_calls(k1_calls + w_k1, k2_calls + w_k2, "deploy round")
    torch.cuda.synchronize()
    out["held_against_plain"] = {"K1": len(k1_calls), "K2": len(k2_calls),
                                 "writers_K1": len(w_k1), "writers_K2": len(w_k2)}
    out["records"] = (rns_main_shape_records(k1_calls, k2_calls, "deploy round, sidecar")
                      + rns_main_shape_records(w_k1, w_k2, "deploy round, bftrw writers"))
    shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"deploy: every sidecar and writer launch of the round equal to its plain version ({out['held_against_plain']}); "
          f"cuts {out['cuts'] or 'none'}; phase {out['phase_s']:.1f} s on {nvidia_smi('name,power.limit')}",
          flush=True)
    return out


def chaos_phase(dev) -> dict:
    """16. The chaos phase (the port of bftkv_tpu/faults/ and the rest of
    bftkv_tpu/obs/): the port's nemesis as its command runs it, ``python -m
    bftkv_tpu_torch.faults.nemesis``, each run a process of its own under
    _recorded_main (its K1/K2 launches counted and their operands kept; the
    failpoint registry and the dispatchers it installs are process-wide and
    end with it), with the host thresholds at 0 so every verify and sign
    batch of the chaos cluster, however small, runs on the card (the
    default crossovers keep a 4 + 4 cluster's batches on the host), and the
    verify memo off: in one process every node's signature is seeded into
    the one shared memo by its signer, so no verify would ever reach a
    kernel, where a deployed replica verifies what it receives: (a) the
    roadmap's stop condition, ``--seed 7 --bits 2048``: the reference's 4 +
    1 + 4 cluster (3f+1, f=1) with 2048-bit keys, every node on the card,
    its fleet collector watching; (b) the documented sidecar chaos form,
    ``--seed 7 --steps 12 --bits 2048 --sidecar --kinds sidecar_crash,
    partition,crash_restart,link_delay,sidecar_crash`` with
    BFTKV_FLIGHT_RECORDER=1: the cluster's verifies and signs through the
    embedded sidecar on the card, zero failed writes in its crash windows,
    sidecar_down raised in each, sign-key handles registered again after
    each restart, one flight-recorder bundle per fault window.  Both must
    exit 0.  Every K1 and K2 launch of the phase is held against its plain
    version; each kernel must launch at least once over the phase."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="smoke-chaos-")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, BFTKV_HOST_VERIFY_THRESHOLD="0", BFTKV_HOST_SIGN_THRESHOLD="0", BFTKV_VERIFY_CACHE="0",
               PYTHONPATH=os.pathsep.join(p for p in (here, os.environ.get("PYTHONPATH")) if p))
    blackbox = os.path.join(root, "blackbox")
    common = ["--seed", str(CHAOS_SEED), "--bits", str(CHAOS_BITS), "--device", str(dev), "--json"]
    runs = [
        ("a", "nemesis", common, {}),
        ("b", "sidecar chaos", common + ["--steps", str(CHAOS_SIDECAR_STEPS), "--sidecar", "--kinds",
                                         CHAOS_SIDECAR_KINDS],
         {"BFTKV_FLIGHT_RECORDER": "1", "BFTKV_RECORDER_DIR": blackbox}),
    ]
    out = {"host_thresholds": 0, "verify_cache": "off", "runs": {}}
    k1_all, k2_all = [], []
    for tag, label, argv, extra in runs:
        rec_path = os.path.join(root, f"{tag}.pt")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", RECORDED, rec_path, "bftkv_tpu_torch.faults.nemesis", *argv],
                           env=dict(env, **extra), capture_output=True, timeout=CHAOS_RUN_TIMEOUT_S)
        wall = time.perf_counter() - t0
        text = r.stdout.decode()
        start = text.find('{\n  "seed"')
        check(start >= 0 and os.path.exists(rec_path),
              f"chaos ({tag}) {label}: exit {r.returncode}, no report; {text[-800:]!r} {r.stderr[-1500:]!r}")
        report = json.loads(text[start:])
        failed = {k: report[k] for k in ("violations", "undetected", "gray_blocked", "sidecar_blocked",
                                         "region_blocked", "recorder_missing") if report[k]}
        check(r.returncode == 0 and report["converged"] and not failed,
              f"chaos ({tag}) {label}: exit {r.returncode}, converged {report['converged']}, {failed}")
        got, k1, k2 = _recorded_calls(rec_path, f"chaos ({tag})", dev)
        check(got["rc"] == 0, f"chaos ({tag}): main returned {got['rc']}")
        launches, snap = got["launches"], got["snap"]
        check(len(k1) == launches["verify"] and len(k2) == launches["pow"]
              and not any(v for name, v in launches.items() if name not in ("verify", "pow")),
              f"chaos ({tag}): recorded launches {len(k1)}, {len(k2)} differ from the counts {launches}")
        k1_all += k1
        k2_all += k2
        det = report["detection"]
        rows = lambda calls: sum(a[0].shape[0] for _p, a in calls)
        run = {
            "argv": argv, "wall_s": wall, "steps": len(report["plan"]),
            "kinds": [s_["kind"] for s_ in report["plan"]],
            "faults_fired": report["faults_fired"], "detected": sum(d["detected"] for d in det),
            "windows": len(det), "anomalies": [d["anomaly"] for d in det], "failures": report["failures"],
            "anomaly_feed": report["anomalies"],
            "k1_launches": launches["verify"], "k1_rows": rows(k1),
            "k2_launches": launches["pow"], "k2_rows": rows(k2),
            "counters": {k: snap.get(k, 0) for k in (
                "verify.device", "verify.host", "sign.device", "sign.host", "verify.remote", "sign.remote",
                "verify.remote_fallback", "sign.remote_fallback", "verify.remote_breaker_open",
                "sign.remote_register", "crypto.sidecar.dishonest")},
        }
        if tag == "b":
            crashes = [d for d in det if d["kind"] == "sidecar_crash"]
            check(bool(crashes) and all(d["anomaly"] in ("sidecar_down", "sidecar_dishonest") for d in crashes),
                  f"chaos (b): a sidecar_crash window without sidecar_down: {crashes}")
            check(run["counters"]["sign.remote_register"] >= len(crashes) + 1,
                  f"chaos (b): {run['counters']['sign.remote_register']} sign-key registrations over "
                  f"{len(crashes)} sidecar restarts")
            windows = [d for d in det if d["anomaly"] != "vacuous"]
            bundles = sorted(n for n in os.listdir(blackbox) if n.startswith("bundle-"))
            check(all(d.get("bundles") == 1 for d in windows) and len(bundles) >= len(windows),
                  f"chaos (b): bundles per window {[d.get('bundles') for d in windows]}, {len(bundles)} on disk")
            run.update(sidecar_crash_windows=len(crashes), bundles_on_disk=len(bundles),
                       recorder=report["recorder"] and {k: v for k, v in report["recorder"].items() if k != "dir"})
        out["runs"][tag] = run
        print(f"chaos ({tag}) {label}: python -m bftkv_tpu_torch.faults.nemesis {' '.join(argv)} exit 0 in "
              f"{wall:.1f} s (process start and key generation included); plan {run['kinds']}; faults fired "
              f"{run['faults_fired']}, windows detected {run['detected']}/{run['windows']} as {run['anomalies']}; "
              f"failures {run['failures']}; on {dev}: K1 {run['k1_launches']} launches ({run['k1_rows']} rows), "
              f"K2 {run['k2_launches']} ({run['k2_rows']} rows); counters {run['counters']}"
              + (f"; {run['sidecar_crash_windows']} sidecar crash windows, {run['bundles_on_disk']} bundles on disk"
                 if tag == "b" else ""), flush=True)
    check(len(k1_all) >= 1 and len(k2_all) >= 1,
          f"the chaos phase launched K1 {len(k1_all)} and K2 {len(k2_all)} times")
    hold_rns_calls(k1_all, k2_all, "chaos phase")
    torch.cuda.synchronize()
    out["held_against_plain"] = {"K1": len(k1_all), "K2": len(k2_all)}
    out["records"] = rns_main_shape_records(k1_all, k2_all, "chaos phase")
    shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"chaos: every K1 and K2 launch of the phase equal to its plain version ({out['held_against_plain']}); "
          f"phase {out['phase_s']:.1f} s on {nvidia_smi('name,power.limit')}", flush=True)
    return out


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(ops: int, nbytes: int) -> tuple[float, str]:
    t_ops = ops / INT8_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_record(name, source, replaces, launches, kernel_fn, plain_fn, ops, n_bytes,
                  kernel_reps, plain_reps, **extra):
    """Kernel vs its plain version on one recorded operand set, and times."""
    got = kernel_fn()
    plain = plain_fn()
    torch.cuda.synchronize()
    check(got.shape == plain.shape, f"{name}: shapes {tuple(got.shape)} != {tuple(plain.shape)}")
    err = int((got.long() - plain.long()).abs().max().item())
    check(err == 0, f"{name}: kernel and plain version differ (max abs err {err})")
    del got, plain
    torch.cuda.empty_cache()
    b_ms, b_by = bound_ms(ops, n_bytes)
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": cuda_ms(kernel_fn, kernel_reps),
        "plain_ms": cuda_ms(plain_fn, plain_reps),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "matches_plain": True,
        **extra,
    }


def rns_record(name, which, replaces, args, launches, kernel_reps, plain_reps, **extra):
    """K1/K2 on recorded (a, b, idx, ukey, cn) operands."""
    from bftkv_tpu_torch.ops import cuda_rns, rns

    a, b, idx, ukey, cn = args
    real = cuda_rns.verify_cuda if which == "verify" else cuda_rns.pow_cuda
    plain = rns._verify_kernel if which == "verify" else rns._pow_kernel
    t, k, digits = a.shape[0], cn.k, cn.digits
    if which == "verify":
        # Two digit -> residue conversions, then 19 Montgomery products
        # (to-Montgomery, 16 squarings, x s, from-Montgomery), two base
        # extensions each.
        conversions, products = 2, 19
    else:
        conversions, products = 1, 2 + 14 + 5 * 4 * digits + 1
    ops_row = (CONV_OPS_PER_MAC * conversions * (2 * digits) * (2 * k + 1)
               + RNS_OPS_PER_MAC * products * 2 * k * (k + 1))
    out_bytes = t * (4 if which == "verify" else 4 * k)
    return kernel_record(
        name, f"bftkv_tpu_torch/ops/csrc/{'rns_chain' if which == 'verify' else 'rns_pow'}.cu",
        replaces, launches,
        lambda: real(*args), lambda: plain(cn, a, b, rns.gather_key(ukey, idx)),
        t * ops_row, nbytes(a, b, idx, *ukey) + nbytes(*cn.kern.values()) + out_bytes,
        kernel_reps, plain_reps, rows=t, k=k, digits=digits, **extra,
    )


def k3_record(args, launches):
    """K3 on recorded (sig, em, n, n', r2) operands: the whole diff."""
    from bftkv_tpu_torch.ops import cuda_mont
    from bftkv_tpu_torch.ops import rsa as rsa_ops

    t = args[0].shape[0]
    n_bytes = 6 * nbytes(args[0])
    # What the chain needs, in 16-bit digit multiply-accumulates (L = 128)
    # with digit-serial Montgomery reduction (L for the m digits, L^2 for
    # m*n): s*r2 and x*s are general products (2L^2 + L), the 16 squarings
    # need L(L+1)/2 + L + L^2, from-Montgomery (x*1) is the reduction alone.
    L = 128
    macs_row = 2 * (2 * L * L + L) + 16 * (L * (L + 1) // 2 + L + L * L) + (L * L + L)
    # A second figure: 19 full products of L^2 (a*b) + L(L+1)/2 (m = t*n' mod
    # R as a half product) + L^2 (m*n), which overcounts the chain's work.
    full_products_ms = bound_ms(
        t * 19 * (2 * L * L + L * (L + 1) // 2) * MONT_OPS_PER_MAC, n_bytes)[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm", "nounits")) * 1e6
    issue_floor_ms = [t * MONT_WORD_MACS_PER_ROW / (sms * rate * clock_hz) * 1e3
                      for rate in IMAD_PER_CLOCK_PER_SM]
    return kernel_record(
        "K3 mont_verify_kernel", "bftkv_tpu_torch/ops/csrc/mont_chain.cu",
        "bftkv_tpu/ops/pallas_mont.py:174", launches,
        lambda: cuda_mont.verify_diff(*args),
        lambda: rsa_ops._verify_chain(*(a.long() for a in args)),
        t * macs_row * MONT_OPS_PER_MAC, n_bytes, kernel_reps=20, plain_reps=2,
        rows=t, compared="(T, 128) diff", bound_ms_19_full_products=full_products_ms,
        cuda_core_issue_floor_ms=issue_floor_ms, sm_clock_max_mhz=clock_hz / 1e6,
    )


def nvidia_smi(query: str, *fmt: str) -> str:
    """The first card's ``nvidia-smi --query-gpu`` fields, as one string."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=" + ",".join(("csv", "noheader", *fmt))],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=20261016)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bftkv_tpu_torch.crypto import rsa
    from bftkv_tpu_torch.metrics import registry as metrics
    from bftkv_tpu_torch.ops import _build, cuda_mont, cuda_rns, dispatch, modexp, rns

    dev = torch.device("cuda", 0)
    build_dir = os.path.dirname(_build.BUILD_DIR)
    # Every phase before the shard phase counts one launch a flush: on a
    # machine with two or more cards they run unsplit, and the shard phase
    # runs the split.
    os.environ.update(BFTKV_SHARD="off")

    # 1. keys and signed items (host, outside every timed phase)
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(8, os.cpu_count() or 1)) as pool:
        replicas, writers, storage_keys = load_keys(pool, args.seed, build_dir)
        items, expect, rns_capable, n_forged, n_hostile, n_big = verify_items(
            pool, replicas, writers, args.seed
        )
        ec_replicas, ec_writers = ec_keys(args.seed)
        ec_items, ec_expect, ec_forged, ec_bad = ec_verify_items(
            pool, ec_replicas, ec_writers, args.seed
        )
    print(f"setup: {len(replicas)} replica + {len(writers)} writer + {len(storage_keys)} storage RSA-2048 keys, "
          f"{len(items)} verify items ({n_forged} forged, {n_hostile} hostile moduli, "
          f"{n_big} with s >= n); {len(ec_replicas)} + {len(ec_writers)} P-256 keys, "
          f"{len(ec_items)} EC verify items ({ec_forged} forged, {ec_bad} malformed) "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    # 2. build (one nvcc per source, in parallel)
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (sm_90a, "
          f"{', '.join(os.path.basename(s) for s in _build.SOURCES)})", flush=True)

    vd = dispatch.VerifyDispatcher(
        rsa.VerifierDomain(device=dev), max_batch=VERIFY_FLUSH, max_wait=2.0
    ).start()
    sd = dispatch.SignDispatcher(
        rsa.SignerDomain(device=dev), max_batch=SIGN_SHARES, max_wait=2.0
    ).start()
    vd_p = dispatch.VerifyDispatcher(
        rsa.VerifierDomain(backend="pallas", device=dev), max_batch=VERIFY_FLUSH, max_wait=2.0
    ).start()
    sd_l = dispatch.SignDispatcher(
        rsa.SignerDomain(backend="limb", device=dev), max_batch=SIGN_SHARES, max_wait=2.0
    ).start()
    try:
        # 3. RNS verify phase (counted)
        with Recorder(cuda_rns, ("verify_cuda", "pow_cuda")) as rec_v, Counted() as c_v:
            got, dt = verify_phase(vd, items)
        v_launch, v_snap = c_v.launches, c_v.snap
        check(got == expect, f"verify verdicts differ from host pow on "
              f"{sum(g != e for g, e in zip(got, expect))} items")
        check(v_snap.get("verify.device", 0) == rns_capable,
              f"verify.device {v_snap.get('verify.device')} != {rns_capable}")
        check(v_snap.get("verify.host", 0) == len(items) - rns_capable,
              f"verify.host {v_snap.get('verify.host')} != {len(items) - rns_capable}")
        check(v_launch["verify"] >= 1, "K1 was not launched by the verify phase")
        print(f"verify phase (rns): {len(items)} items, {sum(expect)} valid, "
              f"verify.device={v_snap.get('verify.device')} "
              f"verify.host={v_snap.get('verify.host')} "
              f"flushes={v_snap.get('dispatch.flushes')} launches={v_launch} "
              f"first run {dt * 1e3:.1f} ms", flush=True)

        # 4. RNS sign phase (counted)
        with Recorder(cuda_rns, ("verify_cuda", "pow_cuda")) as rec_s, Counted() as c_s:
            sign_items, sigs, dt = sign_phase(sd, replicas, "counted")
        s_launch, s_snap = c_s.launches, c_s.snap
        check_signatures(sign_items, sigs, "rns sign")
        check(s_snap.get("sign.device", 0) == SIGN_SHARES,
              f"sign.device {s_snap.get('sign.device')} != {SIGN_SHARES}")
        check(s_snap.get("sign.fault", 0) == 0, f"sign.fault {s_snap.get('sign.fault')}")
        check(s_launch["pow"] >= 1, "K2 was not launched by the sign phase")
        check(s_launch["verify"] >= 1, "the fault check did not launch K1")
        print(f"sign phase (rns): {len(sigs)} signatures, sign.device={s_snap.get('sign.device')} "
              f"sign.fault={s_snap.get('sign.fault', 0)} "
              f"sign.fault_check_divergence={s_snap.get('sign.fault_check_divergence', 0)} "
              f"flushes={s_snap.get('signdispatch.flushes')} launches={s_launch} "
              f"first run {dt * 1e3:.1f} ms", flush=True)

        # 5. pallas verify phase (counted): every item on the device, K3
        with Recorder(cuda_mont, ("verify_cuda",)) as rec_p, Counted() as c_p:
            got, dt = verify_phase(vd_p, items)
        p_launch, p_snap = c_p.launches, c_p.snap
        check(got == expect, f"pallas verdicts differ from host pow on "
              f"{sum(g != e for g, e in zip(got, expect))} items")
        check(p_snap.get("verify.device", 0) == len(items),
              f"pallas verify.device {p_snap.get('verify.device')} != {len(items)}")
        check(p_snap.get("verify.host", 0) == 0, f"pallas verify.host {p_snap.get('verify.host')}")
        check(p_launch["mont_verify"] >= 1
              and p_launch["mont_verify"] == p_snap.get("dispatch.flushes"),
              f"K3 launches {p_launch['mont_verify']} != flushes {p_snap.get('dispatch.flushes')}")
        check(p_launch["verify"] == p_launch["pow"] == 0, f"pallas phase launched {p_launch}")
        print(f"verify phase (pallas): verify.device={p_snap.get('verify.device')} "
              f"verify.host={p_snap.get('verify.host', 0)} "
              f"flushes={p_snap.get('dispatch.flushes')} launches={p_launch} "
              f"first run {dt * 1e3:.1f} ms", flush=True)

        # 6. limb sign phase (counted): one 512-row power_batch, K1 fault check
        with Recorder(cuda_rns, ("verify_cuda",)) as rec_l, Counted() as c_l:
            sign_items, sigs, dt = sign_phase(sd_l, replicas, "limb")
        l_launch, l_snap = c_l.launches, c_l.snap
        check_signatures(sign_items, sigs, "limb sign")
        check(l_snap.get("sign.device", 0) == SIGN_SHARES,
              f"limb sign.device {l_snap.get('sign.device')} != {SIGN_SHARES}")
        check(l_snap.get("sign.fault", 0) == 0, f"limb sign.fault {l_snap.get('sign.fault')}")
        check(l_launch["verify"] >= 1, "the limb sign's fault check did not launch K1")
        check(l_launch["pow"] == 0, "the limb sign launched K2")
        print(f"sign phase (limb): {len(sigs)} signatures, sign.device={l_snap.get('sign.device')} "
              f"sign.fault={l_snap.get('sign.fault', 0)} "
              f"flushes={l_snap.get('signdispatch.flushes')} launches={l_launch} "
              f"first run {dt * 1e3:.1f} ms", flush=True)

        # 10a. timed flushes (after the warm-up above); the verify.launch
        # timer splits a verify flush into the device call and the host.
        metrics.reset()
        v_times = [verify_phase(vd, items)[1] for _ in range(TIMED_REPS)]
        v_timed = metrics.snapshot()
        launch_ms = v_timed["verify.launch.sum"] / v_timed["verify.launch.count"] * 1e3
        s_times = [sign_phase(sd, replicas, f"timed{r}")[2] for r in range(TIMED_REPS)]
        metrics.reset()
        p_times = [verify_phase(vd_p, items)[1] for _ in range(TIMED_REPS)]
        p_timed = metrics.snapshot()
        p_launch_ms = p_timed["verify.launch.sum"] / p_timed["verify.launch.count"] * 1e3
        l_times = [sign_phase(sd_l, replicas, f"limb{r}")[2] for r in range(LIMB_SIGN_REPS)]
    finally:
        for d in (vd, sd, vd_p, sd_l):
            d.stop()

    # 7. BatchModExp phase (counted, each route timed once)
    rng = random.Random(args.seed)
    bme = modexp.BatchModExp(device=dev)
    n = replicas[0].n
    pairs = [(rng.getrandbits(2048), rng.getrandbits(2048)) for _ in range(MODEXP_PAIRS)]
    with Recorder(cuda_rns, ("pow_cuda",)) as rec_m, Counted() as c_m:
        t0 = time.perf_counter()
        vals = bme.modexp(pairs, n)
        m_dt = time.perf_counter() - t0
    check(vals == [pow(b, e, n) for b, e in pairs], "BatchModExp (RNS, 2048-bit) != host pow")
    check(c_m.snap.get("modexp.rns_staged", 0) == MODEXP_PAIRS,
          f"modexp.rns_staged {c_m.snap.get('modexp.rns_staged')} != {MODEXP_PAIRS}")
    check(c_m.launches["pow"] == 1, f"BatchModExp 2048-bit launched {c_m.launches}")
    # The same call again: its staging ring now exists (the first call
    # allocated the ring's pinned host and device tensors).
    t0 = time.perf_counter()
    again = bme.modexp(pairs, n)
    m_dt2 = time.perf_counter() - t0
    check(again == vals, "BatchModExp (RNS, 2048-bit, second call) != host pow")
    frags = [(rng.getrandbits(2048), rng.getrandbits(FRAGMENT_EXP_BITS) | (1 << (FRAGMENT_EXP_BITS - 1)))
             for _ in range(FRAGMENT_PAIRS)]
    with Counted() as c_f:
        t0 = time.perf_counter()
        vals = bme.modexp(frags, n)
        f_dt = time.perf_counter() - t0
    check(vals == [pow(b, e, n) for b, e in frags], "BatchModExp (limb, 2300-bit exponents) != host pow")
    check("modexp.rns_staged" not in c_f.snap and c_f.launches["pow"] == 0,
          f"the 2300-bit exponents did not take the limb path: {c_f.snap} {c_f.launches}")
    print(f"BatchModExp: {MODEXP_PAIRS} 2048-bit pairs (RNS, K2 launches {c_m.launches['pow']}) "
          f"{m_dt * 1e3:.1f} ms (second call {m_dt2 * 1e3:.1f} ms); {FRAGMENT_PAIRS} pairs with "
          f"{FRAGMENT_EXP_BITS}-bit exponents "
          f"(limb, 256-limb bucket) {f_dt * 1e3:.1f} ms", flush=True)

    # 8. dispatch-plane phase: verify and sign at pipeline 1 and 2, the
    # modexp dispatcher, the rings, one verify flush split
    from bftkv_tpu_torch.ops import devbuf

    vds = {pl: dispatch.VerifyDispatcher(rsa.VerifierDomain(device=dev), pipeline=pl,
                                         max_batch=PLANE_MAX_BATCH, max_wait=0.05).start()
           for pl in (1, 2)}
    sds = {pl: dispatch.SignDispatcher(rsa.SignerDomain(device=dev), pipeline=pl,
                                       max_batch=SIGN_SHARES, max_wait=2.0).start()
           for pl in (1, 2)}
    vd_split = dispatch.VerifyDispatcher(rsa.VerifierDomain(device=dev), pipeline=1,
                                         max_batch=VERIFY_FLUSH).start()
    try:
        check(all(vds[pl]._pool is not None and len(vds[pl]._pool.workers) == (pl if pl > 1 else 0)
                  for pl in vds), "plane dispatchers did not start their flush workers")
        pv, pv_args = plane_verify(vds, items, expect)
        ps = plane_sign(sds, replicas)
        pm, pm_args = plane_modexp(dev, replicas, args.seed)
        split = split_verify_flush(vd_split, items)
    finally:
        for d in (*vds.values(), *sds.values(), vd_split):
            d.stop()
    rings = devbuf.stats()
    check(rings and all(r["in_flight"] == 0 for r in rings.values()),
          f"a staging slot is left in flight: {rings}")
    overflows = sum(r["overflows"] for r in rings.values())
    plane = {
        "verify": {f"pipeline_{pl}": {
            "round_ms_median": statistics.median(r["round_s"]) * 1e3,
            "flush_ms_median": statistics.median(r["flush_s"]) * 1e3,
            "flushes": r["flushes"], "k1_launches": r["k1_launches"],
            "k1_launches_by_rows": r["k1_by_rows"],
            "round_ms": [t * 1e3 for t in r["round_s"]]} for pl, r in pv.items()},
        "sign": {f"pipeline_{pl}": {
            "flush_ms_median": statistics.median(r["round_s"]) * 1e3,
            "k2_launches": r["k2_launches"], "k1_launches": r["k1_launches"],
            "flush_ms": [t * 1e3 for t in r["round_s"]]} for pl, r in ps.items()},
        "modexp": pm,
        "rings": {"count": len(rings), "in_flight": 0, "overflows": overflows,
                  "acquires": sum(r["acquires"] for r in rings.values())},
        "verify_flush_split_ms": split,
    }
    for pl in (1, 2):
        v, sg = plane["verify"][f"pipeline_{pl}"], plane["sign"][f"pipeline_{pl}"]
        print(f"plane verify (pipeline {pl}, max_batch {PLANE_MAX_BATCH}): round median "
              f"{v['round_ms_median']:.3f} ms, flush median {v['flush_ms_median']:.3f} ms over "
              f"{v['flushes']} flushes, K1 launches {v['k1_launches']}; sign flush median "
              f"{sg['flush_ms_median']:.3f} ms (K2 {sg['k2_launches']}, K1 {sg['k1_launches']})",
              flush=True)
    print(f"plane modexp: 64 x 2048-bit + 64 x 1024-bit in {pm['flush_ms']:.1f} ms, K2 launches "
          f"{pm['k2_launches']} ({pm['k2_launches_at_first_wait']} at the first wait, k order "
          f"{pm['launch_order_k']}, event gap {pm['event_gap_ms']:.4f} ms); rings {len(rings)}, "
          f"none in flight, overflows {overflows}", flush=True)
    print("plane verify flush split (median of %d, ms): " % SPLIT_REPS
          + ", ".join(f"{k[:-3]} {v:.4f}" for k, v in split.items()), flush=True)

    # 9. EC phase: the same cluster on P-256 identity keys
    ec = ec_phase(dev, items, expect, ec_items, ec_expect, ec_replicas)

    # 10. sidecar phase: the port's crypto sidecar serving 8 tenants
    sidecar = sidecar_phase(dev, items, expect, ec_items, ec_expect, replicas, args.seed)

    # 11. shard phase: the RNS launches split over shards
    shard = shard_phase(dev, items, replicas)

    # 12. quorum phase: the universe, the web-of-trust quorums, the tallies
    # and the replicas' stores
    quorum, qctx = quorum_phase(dev, replicas, writers, storage_keys, args.seed)

    # 13. crypto-layer phase: collective signatures against the writers'
    # quorums, TPA, threshold DSA/ECDSA/RSA, envelopes
    crypto = crypto_phase(dev, replicas, writers, ec_replicas, args.seed, build_dir, qctx)

    # 14. protocol phase: the headline's deployment through the port's own
    # servers, clients and transport
    protocol = protocol_phase(dev, qctx["universe"], replicas, writers, storage_keys, args.seed)

    # 15. deploy phase: the same round through the process surfaces, one
    # daemon process per replica, the card behind one sidecar
    deploy = deploy_phase(dev, replicas, writers, storage_keys, args.seed)

    # 16. chaos phase: the port's nemesis on the card, and its sidecar form
    chaos = chaos_phase(dev)

    v_med, s_med = statistics.median(v_times), statistics.median(s_times)
    p_med, l_med = statistics.median(p_times), statistics.median(l_times)
    print(f"verify flush (rns): median {v_med * 1e3:.3f} ms of {TIMED_REPS} "
          f"({len(items) / v_med:.0f} verifies/s), all {[t * 1e3 for t in v_times]}; "
          f"device call (verify.launch, copies + K1 + sync) mean {launch_ms} ms",
          flush=True)
    print(f"sign flush (rns): median {s_med * 1e3:.3f} ms of {TIMED_REPS} "
          f"({SIGN_SHARES / s_med:.0f} signatures/s), all {[t * 1e3 for t in s_times]}",
          flush=True)
    print(f"verify flush (pallas): median {p_med * 1e3:.3f} ms of {TIMED_REPS} "
          f"({len(items) / p_med:.0f} verifies/s), all {[t * 1e3 for t in p_times]}; "
          f"device call (verify.launch, copies + K3 + sync) mean {p_launch_ms} ms",
          flush=True)
    print(f"sign flush (limb): median {l_med * 1e3:.3f} ms of {LIMB_SIGN_REPS} "
          f"({SIGN_SHARES / l_med:.0f} signatures/s), all {[t * 1e3 for t in l_times]}",
          flush=True)
    print(f"socket hop: sidecar verify flush median {sidecar['verify_flush_ms_median']:.3f} ms "
          f"and tenant round trip median {statistics.median(sidecar['verify_rtt_ms_median_per_tenant']):.3f} "
          f"ms ({VERIFY_FLUSH // SIDECAR_TENANTS} RSA + {SIDECAR_EC_ITEMS // SIDECAR_TENANTS} EC items) "
          f"beside the in-process rns verify flush {v_med * 1e3:.3f} ms; sidecar sign flush median "
          f"{sidecar['sign_flush_ms_median']:.3f} ms and tenant round trip median "
          f"{statistics.median(sidecar['sign_rtt_ms_median_per_tenant']):.3f} ms "
          f"({SIGN_SHARES // SIDECAR_TENANTS} shares) beside the in-process rns sign flush "
          f"{s_med * 1e3:.3f} ms", flush=True)

    # 17. each kernel against its plain version, on the main paths' operands
    v_args = [a for a in rec_v.calls["verify_cuda"] if a[0].shape[0] == VERIFY_FLUSH]
    check(len(v_args) == 1, f"expected one {VERIFY_FLUSH}-row verify launch")
    p_args = rec_s.calls["pow_cuda"]
    check(len(p_args) == 1 and p_args[0][0].shape[0] == 2 * SIGN_SHARES,
          "expected one 512-row pow launch")
    m_args = rec_m.calls["pow_cuda"]
    check(len(m_args) == 1 and m_args[0][4].k == 188, "expected one k=188 pow launch")
    k3_args = rec_p.calls["verify_cuda"]
    check(len(k3_args) == 1 and k3_args[0][0].shape == (VERIFY_FLUSH, 128),
          "expected one (4096, 128) K3 launch")
    # K1's launches by shape: the verify flush (T=4096), the fault checks
    # of both sign backends (T=256).
    k1_calls = {"verify_rns": rec_v.calls["verify_cuda"], "sign_rns": rec_s.calls["verify_cuda"],
                "sign_limb": rec_l.calls["verify_cuda"]}
    check(all(len(k1_calls[ph]) == c["verify"]
              for ph, c in (("verify_rns", v_launch), ("sign_rns", s_launch), ("sign_limb", l_launch))),
          "recorded K1 calls differ from its launch counts")
    by_shape = {t: {ph: sum(a[0].shape[0] == t for a in calls) for ph, calls in k1_calls.items()}
                for t in (VERIFY_FLUSH, SIGN_SHARES)}
    check(sum(sum(c.values()) for c in by_shape.values()) == sum(map(len, k1_calls.values())),
          f"K1 launched at a shape other than T={VERIFY_FLUSH} or T={SIGN_SHARES}")
    check(bool(pv_args), f"expected a T={PLANE_MAX_BATCH} K1 launch in the plane verify phase")
    check([a[0].shape[0] for a in pm_args] == [64, 64], "expected two T=64 K2 launches")
    f_args = k1_calls["sign_rns"] + k1_calls["sign_limb"]
    check(len(f_args) >= 2, "expected a fault check from each sign backend")
    cn_v = rns.consts(rns.DIGITS, 2048, dev)
    for a in f_args:  # every fault check's operands
        g = cuda_rns.verify_cuda(*a)
        pl = rns._verify_kernel(cn_v, a[0], a[1], rns.gather_key(a[3], a[2]))
        check(torch.equal(g, pl), "K1 differs from its plain version on fault-check operands")
    attrs = {**cuda_rns.kernel_attrs(), **cuda_mont.kernel_attrs()}
    launches_of = lambda t: {ph: n for ph, n in by_shape[t].items() if n}
    kernels = [
        rns_record("K1 rns_verify_kernel", "verify", "bftkv_tpu/ops/pallas_rns.py:517",
                   v_args[0], sum(by_shape[VERIFY_FLUSH].values()), 20, 3,
                   phase_launches=launches_of(VERIFY_FLUSH), **attrs["verify"]),
        rns_record("K1 rns_verify_kernel (T=256, fault check)", "verify",
                   "bftkv_tpu/ops/pallas_rns.py:517", k1_calls["sign_rns"][0],
                   sum(by_shape[SIGN_SHARES].values())
                   + sum(ps[pl]["k1_launches"] for pl in ps), 50, 3,
                   phase_launches={**launches_of(SIGN_SHARES),
                                   **{f"plane_sign_p{pl}": ps[pl]["k1_launches"] for pl in ps}},
                   **attrs["verify"]),
        rns_record("K1 rns_verify_kernel (T=1024, dispatch plane)", "verify",
                   "bftkv_tpu/ops/pallas_rns.py:517", pv_args[0],
                   sum(pv[pl]["k1_by_rows"].get(PLANE_MAX_BATCH, 0) for pl in pv), 20, 3,
                   phase_launches={f"plane_verify_p{pl}": pv[pl]["k1_by_rows"] for pl in pv},
                   **attrs["verify"]),
        rns_record("K2 rns_pow_kernel (k=94)", "pow", "bftkv_tpu/ops/pallas_rns.py:403",
                   p_args[0], s_launch["pow"] + sum(ps[pl]["k2_launches"] for pl in ps), 10, 2,
                   phase_launches={"sign_rns": s_launch["pow"],
                                   **{f"plane_sign_p{pl}": ps[pl]["k2_launches"] for pl in ps}},
                   **attrs["pow"]),
        rns_record("K2 rns_pow_kernel (k=94, T=64, modexp dispatcher)", "pow",
                   "bftkv_tpu/ops/pallas_rns.py:403", pm_args[1], 1, 10, 2,
                   phase_launches={"plane_modexp": 1}, **attrs["pow"]),
        rns_record("K2 rns_pow_kernel (k=188)", "pow", "bftkv_tpu/ops/pallas_rns.py:403",
                   m_args[0], c_m.launches["pow"] + 1, 5, 1,
                   phase_launches={"modexp_2048": c_m.launches["pow"], "plane_modexp": 1},
                   **attrs["pow"]),
        k3_record(k3_args[0], p_launch["mont_verify"]),
    ]
    k3 = kernels[-1]
    k3.update(phase_launches={"verify_pallas": p_launch["mont_verify"]}, **attrs["mont_verify"])
    kernels += ec.pop("records")
    kernels += sidecar.pop("records")
    kernels += shard.pop("records")
    kernels += quorum.pop("records")
    kernels += crypto.pop("records")
    kernels += protocol.pop("records")
    kernels += deploy.pop("records")
    kernels += chaos.pop("records")
    print(f"K1 before its redesign, not measured in this run ({K1_EARLIER_OF}): "
          + ", ".join(f"T={t} {ms} ms" for t, ms in K1_EARLIER_MS.items())
          + "; this run: " + ", ".join(f"T={r['rows']} {r['ms']:.4f} ms" for r in kernels[0:3]),
          flush=True)
    print(f"K2 before its redesign, not measured in this run ({K2_EARLIER_OF}): "
          + ", ".join(f"k={k} {ms} ms" for k, ms in K2_EARLIER_MS.items())
          + "; this run: " + ", ".join(f"k={r['k']} {r['ms']:.4f} ms"
                                       for r in (kernels[3], kernels[5])),
          flush=True)
    print(f"K3 before its redesign, not measured in this run ({K3_EARLIER_OF}): "
          + ", ".join(f"T={t} {ms} ms" for t, ms in K3_EARLIER_MS.items())
          + f"; this run: T={k3['rows']} {k3['ms']:.4f} ms", flush=True)
    print(json.dumps({
        "kernels": kernels,
        "not_yet_ported": [],
        "phases": {
            "verify_flush_ms_median": v_med * 1e3,
            "verify_items_per_s": len(items) / v_med,
            "verify_launch_ms_mean": launch_ms,
            "sign_flush_ms_median": s_med * 1e3,
            "signatures_per_s": SIGN_SHARES / s_med,
            "pallas_verify_flush_ms_median": p_med * 1e3,
            "pallas_verify_items_per_s": len(items) / p_med,
            "pallas_verify_launch_ms_mean": p_launch_ms,
            "limb_sign_flush_ms_median": l_med * 1e3,
            "limb_signatures_per_s": SIGN_SHARES / l_med,
            "modexp_2048_rns_ms": m_dt * 1e3,
            "modexp_2048_rns_second_call_ms": m_dt2 * 1e3,
            "modexp_fragment_limb_ms": f_dt * 1e3,
        },
        "dispatch_plane": plane,
        "ec": ec,
        "sidecar": sidecar,
        "shard": shard,
        "quorum": quorum,
        "crypto": crypto,
        "protocol": protocol,
        "deploy": deploy,
        "chaos": chaos,
    }), flush=True)

    # 18. the card, as nvidia-smi reports it
    print(nvidia_smi("name,power.limit") or "nvidia-smi: no output", flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
