"""Smoke run of the PyTorch/CUDA port on one GPU: the replica's crypto plane.

Drives the port's main paths at the size of the 64-replica cluster and
holds every hand-written kernel against its plain PyTorch version:

1. keys: 64 replica RSA-2048 keys and 4 writer keys, drawn from --seed
   (cached under bftkv_tpu_torch/_build/), and as many P-256 keys, with the
   signed verify items of both, outside every timed phase;
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
10. each kernel against its plain version on the card, on the operands the
   main paths gave it: K1 verdicts (T=4096, T=1024 and every fault check's
   T=256), K2 sigma (k=94 at T=512 and T=64, k=188), K3's whole
   (4096, 128) diff and K5's Jacobian residues bit-identical;
11. times: median of 5 timed flushes per verify/RNS-sign phase, 3 for the
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
import json
import multiprocessing
import os
import random
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
# K5's base extensions run on the CUDA cores: per product, k(k+1) multiply-adds
# each way, and 2k + 1 warp shuffles (k per extension, one for alpha) issued at
# one warp instruction per clock per SM.
SHFL_PER_CLOCK_PER_SM = 1


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
    seeds = [seed * 1000 + i for i in range(N_REPLICAS + N_WRITERS)]
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
    return keys[:N_REPLICAS], keys[N_REPLICAS:]


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
    (the Montgomery strip and σ on the card), D2H of σ, decode (CRT
    rebuild, Z inverse) and finish (u1·G +
    u2·Q, r compare, scatter): host clock at the boundaries, CUDA events
    around the copies and the kernel."""
    from bftkv_tpu_torch.ops import cuda_ec, devbuf, ec_rns

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

    rows = []
    ec_rns.scalar_mult_hosts = host_marks("entry", "exit", real["entry"])
    cuda_ec.scalar_mult_cuda = timed_events("k5", real["k5"])
    devbuf.Slot.upload = upload
    devbuf.Slot.download = timed_events("d2h", real["download"])
    ec_rns._P256RNS.strip_sigma = timed_events("strip", real["strip"])
    ec_rns._P256RNS.decode_sigma = host_marks("decode0", "decode1", real["decode"])
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
                "finish_ms": (done - marks["exit"]) * 1e3,
                "flush_ms": (done - marks["start"]) * 1e3,
            })
    finally:
        ec_rns.scalar_mult_hosts, cuda_ec.scalar_mult_cuda = real["entry"], real["k5"]
        devbuf.Slot.upload, devbuf.Slot.download = real["upload"], real["download"]
        ec_rns._P256RNS.strip_sigma = real["strip"]
        ec_rns._P256RNS.decode_sigma = real["decode"]
        del vd.verifier.verify_batch
    return {key: statistics.median(r[key] for r in rows) for key in rows[0]}


def ec_record(args, launches, kernel_reps: int, **extra):
    """K5 on recorded (res, nib, engine) operands: the whole output block."""
    from bftkv_tpu_torch.ops import cuda_ec, ec_rns

    res, nib, eng = args
    t, k = res.shape[-1], eng.k
    macs_point = EC_PRODUCTS * 2 * k * (k + 1)
    n_bytes = 2 * nbytes(res) + nbytes(nib, eng.lane)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm", "nounits")) * 1e6
    floor_ms = t * macs_point / (sms * IMAD_PER_CLOCK_PER_SM[0] * clock_hz) * 1e3
    shfl_ms = t * EC_PRODUCTS * (2 * k + 1) / (sms * SHFL_PER_CLOCK_PER_SM * clock_hz) * 1e3
    return kernel_record(
        "K5 ec_scalar_mult_kernel", "bftkv_tpu_torch/ops/csrc/ec_p256.cu",
        "bftkv_tpu/ops/ec_rns.py:437", launches,
        lambda: cuda_ec.scalar_mult_cuda(res, nib, eng),
        lambda: ec_rns._scalar_mult(eng, res, nib),
        t * macs_point * RNS_OPS_PER_MAC, n_bytes, kernel_reps, 1,
        rows=t, k=k, compared="(3, 2k+1, T) Jacobian residues",
        products_per_point=EC_PRODUCTS, cuda_core_floor_ms=floor_ms,
        shuffle_issue_floor_ms=shfl_ms, sm_clock_max_mhz=clock_hz / 1e6, **extra,
    )


def k5_edge_lanes(dev) -> None:
    """K5 against its plain version at T=16 on the group law's edge lanes:
    identity points, scalars 0, 1, 2 (a doubling lane), n − 1, and the raw
    windows of n and n + 1.  The flushes never reach n's lane, whose last
    add is P + (−P), because ``ec_rns._nibbles`` reduces scalars mod n;
    there K5 must give Z = 0 exactly in every channel."""
    import numpy as np

    from bftkv_tpu_torch.crypto.ec import P256
    from bftkv_tpu_torch.ops import cuda_ec, ec_rns

    eng = ec_rns.engine(dev)
    g, n = (P256.gx, P256.gy), P256.n
    rng = random.Random(16)
    pts = [None, None, g, g, g, g, g, g] + [P256.scalar_base_mult(i + 7) for i in range(8)]
    ks = [5, 0, 0, 1, 2, n - 1, n, n + 1] + [rng.randrange(n) for _ in range(8)]
    block = np.zeros((3, 2 * eng.k + 1, len(pts)), dtype=np.int32)
    eng.encode_points_into(pts, block)
    nib = ec_rns._nibbles(ks)
    for lane in (6, 7):
        nib[:, lane] = [(ks[lane] >> (4 * (63 - w))) & 0xF for w in range(64)]
    res, nib = torch.from_numpy(block).to(dev), torch.from_numpy(nib).to(dev)
    got = cuda_ec.scalar_mult_cuda(res, nib, eng)
    check(torch.equal(got, ec_rns._scalar_mult(eng, res, nib)),
          "K5 differs from its plain version on the edge lanes")
    check(not got[2, :, 6].any(), "K5: P + (−P) left a nonzero Z")
    check(eng.decode_points(got) == [P256.scalar_mult(p, k) if p is not None else None
                                     for p, k in zip(pts, ks)],
          "K5 edge lanes differ from the host curve")
    print("K5 edge lanes (T=16: identities, 0, 1, 2, n - 1, raw n = P + (-P), raw n + 1): "
          "equal to the plain version, Z = 0 on the P + (-P) lane", flush=True)


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
          + ", ".join(f"{k[:-3]} {v:.4f}" for k, v in split.items()), flush=True)

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

    # 1. keys and signed items (host, outside every timed phase)
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(8, os.cpu_count() or 1)) as pool:
        replicas, writers = load_keys(pool, args.seed, build_dir)
        items, expect, rns_capable, n_forged, n_hostile, n_big = verify_items(
            pool, replicas, writers, args.seed
        )
        ec_replicas, ec_writers = ec_keys(args.seed)
        ec_items, ec_expect, ec_forged, ec_bad = ec_verify_items(
            pool, ec_replicas, ec_writers, args.seed
        )
    print(f"setup: {len(replicas)} replica + {len(writers)} writer RSA-2048 keys, "
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

    # 10. each kernel against its plain version, on the main paths' operands
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
    }), flush=True)

    # 11. the card, as nvidia-smi reports it
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
