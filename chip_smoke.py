"""Smoke run of the PyTorch/CUDA port on one GPU: the replica's crypto plane.

Drives the port's main path at the size of the 64-replica cluster and
holds every hand-written kernel against its plain PyTorch version:

1. keys: 64 replica RSA-2048 keys and 4 writer keys, drawn from --seed
   (cached under bftkv_tpu_torch/_build/), outside every timed phase;
2. build: the kernels from bftkv_tpu_torch/ops/csrc/ for sm_90a;
3. verify phase: 64 threads, one per replica, submit their share of one
   4096-item flush to VerifyDispatcher(max_batch=4096): about 93 writes x
   44 verifies (writer signature + 43 collective entries), 1% forged by a
   bit flip, a few hostile moduli (sharing a channel prime), a few s >= n.
   Verdicts must equal host pow(s, 65537, n) == em;
4. sign phase: 64 threads sign 256 collective shares through
   SignDispatcher(max_batch=256): 512 half-width rows in one K2 launch,
   then the fault check (one K1 launch).  Every signature must verify on
   the host and equal host signing;
5. each kernel against its plain version on the card, on the operands the
   main path gave it: K1 verdicts and K2 sigma bit-identical;
6. times: median of 5 timed flushes per phase, and kernel times by CUDA
   events (K1 at T=4096, K2 at T=512), beside nvidia-smi's name and limit.

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

# Card peaks (NVIDIA H100 SXM data sheet, dense): int8 tensor cores and HBM3.
INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12
# An exact product of two 12-bit residues takes four int8 products on the
# tensor cores (6-bit split, as the TPU kernels' bf16 planes): 8 ops per MAC.
OPS_PER_MAC = 8


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


class Recorder:
    """Keeps the operands the main path hands each kernel wrapper."""

    def __init__(self, cuda_rns):
        self.mod = cuda_rns
        self.real = {"verify": cuda_rns.verify_cuda, "pow": cuda_rns.pow_cuda}
        self.calls = {"verify": [], "pow": []}

    def __enter__(self):
        for name, fn in self.real.items():
            setattr(self.mod, f"{name}_cuda", self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def rec(*args):
            self.calls[name].append(args)
            return fn(*args)

        return rec

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.mod, f"{name}_cuda", fn)


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


def bound_ms(macs: int, nbytes: int) -> tuple[float, str]:
    t_ops = macs * OPS_PER_MAC / INT8_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_record(name, which, source, replaces, args, cn, launches, plain_fn,
                  kernel_reps, plain_reps):
    """Kernel vs plain version on one recorded operand set, and times."""
    from bftkv_tpu_torch.ops import cuda_rns, rns

    real = cuda_rns.verify_cuda if which == "verify" else cuda_rns.pow_cuda
    a, b, idx, ukey, _cn = args
    got = real(*args)
    plain = plain_fn(cn, a, b, rns.gather_key(ukey, idx))
    torch.cuda.synchronize()
    err = int((got.long() - plain.long()).abs().max().item())
    check(err == 0, f"{name}: kernel and plain version differ (max abs err {err})")
    t = a.shape[0]
    k, digits = cn.k, cn.digits
    if which == "verify":
        macs_row = 2 * (2 * digits) * (2 * k + 1) + 18 * 2 * k * (k + 1)
    else:
        steps = 4 * digits
        products = 2 + 14 + 5 * steps + 1
        macs_row = (2 * digits) * (2 * k + 1) + products * 2 * k * (k + 1)
    kc = cn.kern
    consts_bytes = nbytes(*kc.values())
    out_bytes = got.numel() * 4
    b_ms, b_by = bound_ms(t * macs_row, nbytes(a, b, idx, *ukey) + consts_bytes + out_bytes)
    ms = cuda_ms(lambda: real(*args), kernel_reps)
    plain_ms = cuda_ms(lambda: plain_fn(cn, a, b, rns.gather_key(ukey, idx)), plain_reps)
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "rows": t,
        "matches_plain": True,
    }


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
    from bftkv_tpu_torch.ops import _build, cuda_rns, dispatch, rns

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
    print(f"setup: {len(replicas)} replica + {len(writers)} writer RSA-2048 keys, "
          f"{len(items)} verify items ({n_forged} forged, {n_hostile} hostile moduli, "
          f"{n_big} with s >= n) in {time.perf_counter() - t0:.1f} s", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (sm_90a, {_build.SOURCES[0]})",
          flush=True)

    vd = dispatch.VerifyDispatcher(
        rsa.VerifierDomain(device=dev), max_batch=VERIFY_FLUSH, max_wait=2.0
    ).start()
    sd = dispatch.SignDispatcher(
        rsa.SignerDomain(device=dev), max_batch=SIGN_SHARES, max_wait=2.0
    ).start()
    try:
        # 3. verify phase (counted: counts to 0 just before, read just after)
        with Recorder(cuda_rns) as rec_v:
            metrics.reset()
            cuda_rns.reset_launches()
            got, dt = verify_phase(vd, items)
            v_launch = dict(cuda_rns.LAUNCHES)
            v_snap = metrics.snapshot()
        check(got == expect, f"verify verdicts differ from host pow on "
              f"{sum(g != e for g, e in zip(got, expect))} items")
        check(v_snap.get("verify.device", 0) == rns_capable,
              f"verify.device {v_snap.get('verify.device')} != {rns_capable}")
        check(v_snap.get("verify.host", 0) == len(items) - rns_capable,
              f"verify.host {v_snap.get('verify.host')} != {len(items) - rns_capable}")
        check(v_launch["verify"] >= 1, "K1 was not launched by the verify phase")
        print(f"verify phase: {len(items)} items, {sum(expect)} valid, "
              f"verify.device={v_snap.get('verify.device')} "
              f"verify.host={v_snap.get('verify.host')} "
              f"flushes={v_snap.get('dispatch.flushes')} launches={v_launch} "
              f"first run {dt * 1e3:.1f} ms", flush=True)

        # 4. sign phase (counted)
        with Recorder(cuda_rns) as rec_s:
            metrics.reset()
            cuda_rns.reset_launches()
            sign_items, sigs, dt = sign_phase(sd, replicas, "counted")
            s_launch = dict(cuda_rns.LAUNCHES)
            s_snap = metrics.snapshot()
        for (m, key), sig in zip(sign_items, sigs):
            check(rsa.verify_host(m, sig, key.public), "a signature fails host verify")
            check(sig == rsa.sign(m, key), "a signature differs from host signing")
        check(s_snap.get("sign.device", 0) == SIGN_SHARES,
              f"sign.device {s_snap.get('sign.device')} != {SIGN_SHARES}")
        check(s_snap.get("sign.fault", 0) == 0, f"sign.fault {s_snap.get('sign.fault')}")
        check(s_launch["pow"] >= 1, "K2 was not launched by the sign phase")
        check(s_launch["verify"] >= 1, "the fault check did not launch K1")
        print(f"sign phase: {len(sigs)} signatures, sign.device={s_snap.get('sign.device')} "
              f"sign.fault={s_snap.get('sign.fault', 0)} "
              f"sign.fault_check_divergence={s_snap.get('sign.fault_check_divergence', 0)} "
              f"flushes={s_snap.get('signdispatch.flushes')} launches={s_launch} "
              f"first run {dt * 1e3:.1f} ms", flush=True)

        # 6a. timed flushes (after the warm-up above); the verify.launch
        # timer splits a verify flush into the device call and the host.
        metrics.reset()
        v_times = [verify_phase(vd, items)[1] for _ in range(TIMED_REPS)]
        v_timed = metrics.snapshot()
        launch_ms = v_timed["verify.launch.sum"] / v_timed["verify.launch.count"] * 1e3
        s_times = [sign_phase(sd, replicas, f"timed{r}")[2] for r in range(TIMED_REPS)]
    finally:
        vd.stop()
        sd.stop()
    v_med, s_med = statistics.median(v_times), statistics.median(s_times)
    print(f"verify flush: median {v_med * 1e3:.3f} ms of {TIMED_REPS} "
          f"({len(items) / v_med:.0f} verifies/s), all {[t * 1e3 for t in v_times]}; "
          f"device call (verify.launch, copies + K1 + sync) mean {launch_ms} ms",
          flush=True)
    print(f"sign flush: median {s_med * 1e3:.3f} ms of {TIMED_REPS} "
          f"({SIGN_SHARES / s_med:.0f} signatures/s), all {[t * 1e3 for t in s_times]}",
          flush=True)

    # 5. each kernel against its plain version, on the main path's operands
    v_args = [a for a in rec_v.calls["verify"] if a[0].shape[0] == VERIFY_FLUSH]
    check(len(v_args) == 1, f"expected one {VERIFY_FLUSH}-row verify launch")
    fc_args = rec_s.calls["verify"]
    p_args = rec_s.calls["pow"]
    check(len(p_args) == 1 and p_args[0][0].shape[0] == 2 * SIGN_SHARES,
          "expected one 512-row pow launch")
    cn_v = rns.consts(rns.DIGITS, 2048, dev)
    cn_p = p_args[0][4]
    for a in fc_args:  # the sign phase's fault-check operands, too
        g = cuda_rns.verify_cuda(*a)
        pl = rns._verify_kernel(cn_v, a[0], a[1], rns.gather_key(a[3], a[2]))
        check(torch.equal(g, pl), "K1 differs from its plain version on fault-check operands")
    k1 = kernel_record(
        "K1 rns_verify_kernel", "verify", "bftkv_tpu_torch/ops/csrc/rns_chain.cu",
        "bftkv_tpu/ops/pallas_rns.py:517", v_args[0], cn_v,
        v_launch["verify"] + s_launch["verify"], rns._verify_kernel,
        kernel_reps=20, plain_reps=3,
    )
    k2 = kernel_record(
        "K2 rns_pow_kernel", "pow", "bftkv_tpu_torch/ops/csrc/rns_chain.cu",
        "bftkv_tpu/ops/pallas_rns.py:403", p_args[0], cn_p,
        v_launch["pow"] + s_launch["pow"], rns._pow_kernel,
        kernel_reps=10, plain_reps=2,
    )
    k1["phase_launches"] = {"verify": v_launch["verify"], "sign": s_launch["verify"]}
    k2["phase_launches"] = {"verify": v_launch["pow"], "sign": s_launch["pow"]}
    attrs = cuda_rns.kernel_attrs()  # registers / local bytes per thread, as built
    k1.update(attrs["verify"])
    k2.update(attrs["pow"])
    print(json.dumps({
        "kernels": [k1, k2],
        "not_yet_ported": [{
            "name": "K3 pallas_mont verify_e65537",
            "replaces": "bftkv_tpu/ops/pallas_mont.py:174",
            "status": "not yet ported (limb-backend slice, ROADMAP M7)",
        }],
        "phases": {
            "verify_flush_ms_median": v_med * 1e3,
            "verify_items_per_s": len(items) / v_med,
            "verify_launch_ms_mean": launch_ms,
            "sign_flush_ms_median": s_med * 1e3,
            "signatures_per_s": SIGN_SHARES / s_med,
        },
    }), flush=True)

    # 6b. the card, as nvidia-smi reports it
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
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
