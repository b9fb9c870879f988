"""Times K1 (``rns_verify_kernel``), K2 (``rns_pow_kernel``), K3
(``mont_verify_kernel``) and K5 (``ec_scalar_mult_kernel``) on one GPU.

All run on seeded operands at the main path's shapes:

- K1 at k=188, 128 digits: T=4096 (the ``rns`` verify flush) and T=256
  (the fault check of one 256-share sign flush), half the rows valid
  signatures;
- K2 at k=94, 64 digits, T=512 (the RNS sign flush), at k=188, 128 digits,
  T=64 (2048-bit ``BatchModExp``) and at k=94, T=4096.  Besides the
  library's own rows-per-block count (``RNS_POW_ROWS`` in
  ``ops/csrc/rns_pow.cu``), each count in ``--rows`` is built as a copy of
  the kernels (``-DRNS_POW_ROWS=R``, under
  ``bftkv_tpu_torch/_build/kernels_rowsR/``);
- K3 at T=4096 (the ``pallas`` verify flush) and T=256, on
  :func:`mont_operands`' rows, which the card tests share: valid, forged,
  s = 0 and s >= n rows, the moduli 2^2048 - 1 and 2^2047 + 1 and the
  multiplicands that stress the carries;
- K5 at T=8192 (the EC verify flush), 2048 (the EC plane), 4096 (the mixed
  flush) and 256 (the EC sign flush), on :func:`ec_operands`' points,
  which the card tests and ``chip_smoke.py`` share: the group law's edge
  lanes first, then seeded points and scalars.

``--other NAME=DIR`` (repeatable) builds another library from DIR's copies
of the kernel sources (an earlier tree's ``bftkv_tpu_torch/ops/csrc``, or
a variant) and times its kernels on the same operands under NAME.  K1, K2
and K3 need this tree's C interface (PR 5 or later); K5 binds either this
tree's launcher or the one-warp-a-point launcher of PR 8, which takes a
lane table, built by the ``ops/ec_rns.py`` beside DIR.

Every variant is timed in turns by CUDA events (each once, then again in
reverse order) and must agree with the plain version bit for bit; one that
cannot launch (shared memory) is recorded with its error.

Run from the repository root:
    python3 -m bftkv_tpu_torch.tools.time_rns [--kernels k1,k2,k3,k5]
        [--rows 2,8] [--other NAME=DIR ...]
It prints one JSON object, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import random
import subprocess
import sys

import numpy as np
import torch

from bftkv_tpu_torch.crypto.ec import P256
from bftkv_tpu_torch.ops import _build, bigint, cuda_ec, cuda_mont, cuda_rns, ec_rns, limb, rns
from bftkv_tpu_torch.ops import rsa as rsa_ops

REPS = 10
K1_ROWS = (4096, 256)
K2_SHAPES = ((64, 1024, 512), (128, 2048, 64), (64, 1024, 4096))  # (digits, n_bits, T)
K3_ROWS = (4096, 256)
K5_ROWS = (8192, 2048, 4096, 256)
R = 1 << 2048
#: Lanes of :func:`ec_operands` whose nibble column holds the raw windows
#: of n and n + 1: the accumulator before the last add is −(n mod 16)·G,
#: so n's last add is P + (−P) (an exact-0 Z) and n + 1's is a plain add.
EC_RAW_N, EC_RAW_N1 = 6, 7


def _moduli(ctx, bits: int, count: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        n = int.from_bytes(rng.bytes(bits // 8), "big") | 1 | (1 << (bits - 1))
        if ctx.key_rows(n) is not None:
            out.append(n)
    return out


def _ukey(ctx, ns, dev):
    return rns.key_rows_from_numpy(rns.stack_key_rows([ctx.key_rows(n) for n in ns]), dev)


def _pow_operands(digits: int, n_bits: int, rows: int, n_keys: int, dev, seed: int):
    ctx = rns.context(digits, n_bits)
    ns = _moduli(ctx, n_bits, n_keys, seed)
    rng = np.random.default_rng(seed + 1)
    idx = torch.as_tensor(rng.integers(0, n_keys, rows).astype(np.int32), device=dev)
    bh = torch.as_tensor(rng.integers(0, 256, (rows, 2 * digits)).astype(np.uint8), device=dev)
    nib = torch.as_tensor(rng.integers(0, 16, (4 * digits, rows)).astype(np.uint8), device=dev)
    return (bh, nib, idx, _ukey(ctx, ns, dev), rns.consts(digits, n_bits, dev))


def _verify_operands(rows: int, n_keys: int, dev, seed: int):
    """(sig_h, em_h, idx, ukey, cn) at k=188: rows i % 2 == 0 hold valid
    signatures, the others a random em."""
    ctx = rns.context()
    ns = _moduli(ctx, 2048, n_keys, seed)
    rng = random.Random(seed + 1)
    idx = [rng.randrange(n_keys) for _ in range(rows)]
    sigs = [rng.randrange(ns[i]) for i in idx]
    ems = [pow(s, 65537, ns[i]) if j % 2 == 0 else rng.randrange(ns[i])
           for j, (s, i) in enumerate(zip(sigs, idx))]
    halves = lambda xs: torch.as_tensor(
        rns.digits_to_halves_u8(np.stack([limb.int_to_limbs(x, rns.DIGITS) for x in xs])),
        device=dev)
    return (halves(sigs), halves(ems), torch.as_tensor(np.asarray(idx, np.int32), device=dev),
            _ukey(ctx, ns, dev), rns.consts(rns.DIGITS, 2048, dev))


def mont_operands(n_rows: int, seed: int, dev):
    """Seeded K3 operands (sig, em, n, n', r2), five (n_rows, 128) int32
    tensors of 16-bit digits on ``dev``, and the host verdicts.

    Rows take one of five moduli: three random 2048-bit ones, 2^2048 - 1
    and 2^2047 + 1.  Every seventh row holds s = 0 or a raw s >= n; rows
    j % 7 = 3, 5 and 6 hold s = n - 1, the s whose Montgomery form is n - 1
    (so the first squaring is (n-1)^2) and the all-ones number mod n; the
    rest a random s < n.  em is s^65537 mod n on rows j % 3 != 0, a random
    2040-bit number on the others.
    """
    rng = random.Random(seed)
    ns = [rng.getrandbits(2048) | 1 | (1 << 2047) for _ in range(3)] + [R - 1, (1 << 2047) + 1]
    doms = [bigint.MontgomeryDomain(n, 128) for n in ns]
    idx = [rng.randrange(len(ns)) for _ in range(n_rows)]

    def sig(j: int, n: int) -> int:
        if j % 7 == 0:
            return (0, rng.randrange(n, R))[j % 2]
        if j % 7 in (3, 5, 6):
            return {3: n - 1, 5: -pow(R, -1, n) % n, 6: (R - 1) % n}[j % 7]
        return rng.randrange(n)

    sigs = [sig(j, ns[i]) for j, i in enumerate(idx)]
    ems = [pow(s, 65537, ns[i]) if j % 3 else rng.getrandbits(2040)
           for j, (s, i) in enumerate(zip(sigs, idx))]
    t = lambda rows: torch.as_tensor(np.stack(rows).astype(np.int32), device=dev)
    ops = (
        t([limb.int_to_limbs(s, 128) for s in sigs]),
        t([limb.int_to_limbs(e, 128) for e in ems]),
        t([doms[i].n for i in idx]), t([doms[i].n_prime for i in idx]),
        t([doms[i].r2 for i in idx]),
    )
    return ops, [pow(s, 65537, ns[i]) == e for s, e, i in zip(sigs, ems, idx)]


def raw_nibbles(s: int) -> list[int]:
    """The 64 window values of ``s`` itself, most significant first: unlike
    ``ec_rns._nibbles``, not reduced mod n."""
    return [(s >> (4 * (63 - w))) & 0xF for w in range(64)]


def ec_operands(t: int, seed: int, dev):
    """Staged K5 operands at T = t: (engine, res, nib, points, scalars).

    The edge lanes come first, all in K5's first group of 8 points:
    identity points (scalars 5 and 0), scalars 0, 1, 2 (the doubling lane
    2·G) and n − 1 of G, the raw windows of n (whose last add is P + (−P))
    and of n + 1; then 3·G, 15 seeded random points and, past lane 24, G,
    each with a seeded scalar.  ``scalars`` are the integers each lane
    computes (n and n + 1 unreduced)."""
    g, n = (P256.gx, P256.gy), P256.n
    rng = random.Random(seed)
    pts = [None, None, g, g, g, g, g, g, g]
    ks = [5, 0, 0, 1, 2, n - 1, n, n + 1, 3]
    while len(pts) < t:
        pts.append(P256.scalar_base_mult(rng.randrange(1, n)) if len(pts) < 24 else g)
        ks.append(rng.randrange(n))
    pts, ks = pts[:t], ks[:t]
    eng = ec_rns.engine(dev)
    block = np.zeros((3, 2 * eng.k + 1, t), dtype=np.int32)
    ec_rns.engine("cpu").encode_points_into(pts, block)
    nib = ec_rns._nibbles(ks)
    for lane in (EC_RAW_N, EC_RAW_N1):
        if lane < t:
            nib[:, lane] = raw_nibbles(ks[lane])
    return (eng, torch.from_numpy(block).to(dev), torch.from_numpy(nib).to(dev), pts, ks)


def _ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def _through(lib, fn):
    """``fn`` with the wrappers launching through ``lib``."""
    def run(*a):
        saved = _build._lib
        _build._lib = lib
        try:
            return fn(*a)
        finally:
            _build._lib = saved
    return run


def _k5_variant(lib, src_dir: str):
    """K5 of another library, bound by its own C interface: this tree's, or
    PR 8's one-warp-a-point launcher (res, nib, lane_tab, chan, T, out,
    stream), fed the lane table of the ``ec_rns.py`` beside ``src_dir``."""
    with open(os.path.join(src_dir, "ec_p256.cu")) as f:
        if "lane_tab" not in f.read():
            return _through(lib, cuda_ec.scalar_mult_cuda)
    path = os.path.join(src_dir, os.pardir, "ec_rns.py")
    spec = importlib.util.spec_from_file_location("_other_ec_rns", path)
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    fn = lib.ec_scalar_mult_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    lanes = {}

    def run(res, nib, eng):
        if res.device not in lanes:
            lanes[res.device] = torch.as_tensor(other.lane_table(eng.ctx), device=res.device)
        out = torch.empty_like(res)
        rc = fn(res.data_ptr(), nib.data_ptr(), lanes[res.device].data_ptr(), res.shape[1],
                res.shape[2], out.data_ptr(), torch.cuda.current_stream(res.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ec_scalar_mult ({src_dir}) launch failed ({rc})")
        return out

    return run


def _time(variants: dict, args, plain, same) -> dict:
    rec = {"ms": {}, "errors": {}, "bit_identical": {}}
    live = []
    for name, fn in variants.items():
        try:
            got = fn(*args)
            torch.cuda.synchronize()
        except RuntimeError as e:
            rec["errors"][name] = str(e)
            continue
        rec["bit_identical"][name] = same(got, plain)
        live.append(name)
    for name in live + live[::-1]:
        rec["ms"].setdefault(name, []).append(_ms(lambda: variants[name](*args)))
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default="k1,k2,k3,k5", help="comma-separated kernels to time")
    ap.add_argument("--rows", default="", help="comma-separated K2 rows per block to build besides the library's")
    ap.add_argument("--other", action="append", default=[], metavar="NAME=DIR",
                    help="also build and time the kernel sources in DIR (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_rns: needs one CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    which = set(args.kernels.split(","))
    _build.library()
    attrs = {"current": {**cuda_rns.kernel_attrs(), **cuda_mont.kernel_attrs(),
                         **cuda_ec.kernel_attrs()}}
    built = attrs["current"]["pow"]["rows_per_block"]
    k1 = {"current": cuda_rns.verify_cuda}
    k2 = {f"rows{built}": cuda_rns.pow_cuda}
    k3 = {"current": cuda_mont.verify_diff}
    k5 = {"current": cuda_ec.scalar_mult_cuda}
    for r in sorted({int(x) for x in args.rows.split(",") if x} - {built}):
        lib = _build.load(f"bftkv_kernels_rows{r}",
                          os.path.join(os.path.dirname(_build.BUILD_DIR), f"kernels_rows{r}"),
                          defines=(f"RNS_POW_ROWS={r}",))
        attrs[f"rows{r}"] = _through(lib, cuda_rns.kernel_attrs)()
        k2[f"rows{r}"] = _through(lib, cuda_rns.pow_cuda)
    for spec in args.other:
        name, _, src = spec.partition("=")
        srcs = [os.path.abspath(os.path.join(src, os.path.basename(s))) for s in _build.SOURCES]
        lib = ctypes.CDLL(_build.build(
            f"bftkv_kernels_{name}", os.path.join(os.path.dirname(_build.BUILD_DIR), f"kernels_{name}"),
            sources=srcs))
        _build.bind(lib)
        # K3's registers and local bytes come from the library; its threads
        # per row and rows per block are this tree's constants, so not its.
        # K3's and K5's registers and local bytes come from the library;
        # K3's threads per row and rows per block are this tree's constants,
        # so not its, and PR 8's K5 reports no blocks per SM.
        mont = _through(lib, cuda_mont.kernel_attrs)()["mont_verify"]
        ec = _through(lib, cuda_ec.kernel_attrs)()["ec_scalar_mult"]
        attrs[name] = {**_through(lib, cuda_rns.kernel_attrs)(),
                       "mont_verify": {k: mont[k] for k in ("registers", "local_bytes")},
                       "ec_scalar_mult": {k: ec[k] for k in ("registers", "local_bytes",
                                                             "points_per_block")}}
        k1[name] = _through(lib, cuda_rns.verify_cuda)
        k2[name] = _through(lib, cuda_rns.pow_cuda)
        k3[name] = _through(lib, cuda_mont.verify_diff)
        k5[name] = _k5_variant(lib, src)

    out = {"built_rows": built, "attrs": attrs, "k1": [], "k2": [], "k3": [], "k5": []}
    ok = True
    full = _verify_operands(max(K1_ROWS), 8, dev, seed=61)
    for t in K1_ROWS if "k1" in which else ():
        a = tuple(x[:t] for x in full[:3]) + full[3:]
        plain = rns._verify_kernel(a[4], a[0], a[1], rns.gather_key(a[3], a[2]))
        rec = {"k": a[4].k, "digits": a[4].digits, "rows": t,
               "valid_rows": int(plain.sum().item()),
               **_time(k1, a, plain, lambda g, p: bool(torch.equal(g, p)))}
        ok = ok and all(rec["bit_identical"].values()) and not rec["errors"]
        out["k1"].append(rec)
    for digits, n_bits, t in K2_SHAPES if "k2" in which else ():
        a = _pow_operands(digits, n_bits, t, 8, dev, seed=digits + t)
        plain = rns._pow_kernel(a[4], a[0], a[1], rns.gather_key(a[3], a[2]))
        rec = {"k": a[4].k, "digits": digits, "rows": t,
               **_time(k2, a, plain, lambda g, p: bool(torch.equal(g.long(), p)))}
        ok = ok and all(rec["bit_identical"].values())
        out["k2"].append(rec)
    ops, want = mont_operands(max(K3_ROWS), 71, dev)
    for t in K3_ROWS if "k3" in which else ():
        a = tuple(x[:t] for x in ops)
        plain = rsa_ops._verify_chain(*(x.long() for x in a))
        rec = {"rows": t, "valid_rows": sum(want[:t]),
               **_time(k3, a, plain, lambda g, p: bool(torch.equal(g.long(), p)))}
        ok = ok and all(rec["bit_identical"].values()) and not rec["errors"]
        out["k3"].append(rec)
    for t in K5_ROWS if "k5" in which else ():
        eng, res, nib, _pts, _ks = ec_operands(t, t, dev)
        plain = ec_rns._scalar_mult(eng, res, nib)
        rec = {"rows": t, **_time(k5, (res, nib, eng), plain,
                                  lambda g, p: bool(torch.equal(g, p)))}
        rec["edge_z_exact_zero"] = not plain[2, :, EC_RAW_N].any().item()
        ok = ok and all(rec["bit_identical"].values()) and not rec["errors"]
        out["k5"].append(rec)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(json.dumps(out), flush=True)
    if not ok:
        print("time_rns: a variant disagrees with the plain version or did not launch",
              file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
