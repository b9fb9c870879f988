"""Times K2 (``rns_pow_kernel``) at candidate rows per block on one GPU.

The library builds K2 at one rows-per-block count (``RNS_POW_ROWS`` in
``ops/csrc/rns_pow.cu``).  This script builds a copy of the kernels for
each other count in ``--rows`` (``-DRNS_POW_ROWS=R``, under
``bftkv_tpu_torch/_build/kernels_rowsR/``) and times them on the same
seeded operands at the main path's two shapes (k=94, 64 digits, T=512:
the RNS sign flush; k=188, 128 digits, T=64: 2048-bit ``BatchModExp``)
and at k=94, T=4096, in turns (each count, then back in reverse order)
by CUDA events.  Every count must agree with the plain version bit for
bit; one that cannot launch (shared memory) is recorded with its error.

Run from the repository root:
    python3 -m bftkv_tpu_torch.tools.time_k2_rows [--rows 2,4,8]
It prints one JSON object, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

from bftkv_tpu_torch.ops import _build, cuda_rns, rns

REPS = 10
SHAPES = ((64, 1024, 512), (128, 2048, 64), (64, 1024, 4096))  # (digits, n_bits, T)


def _moduli(ctx, bits: int, count: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        n = int.from_bytes(rng.bytes(bits // 8), "big") | 1 | (1 << (bits - 1))
        if ctx.key_rows(n) is not None:
            out.append(n)
    return out


def _operands(digits: int, n_bits: int, rows: int, n_keys: int, dev, seed: int):
    ctx = rns.context(digits, n_bits)
    ns = _moduli(ctx, n_bits, n_keys, seed)
    rng = np.random.default_rng(seed + 1)
    ukey = rns.key_rows_from_numpy(rns.stack_key_rows([ctx.key_rows(n) for n in ns]), dev)
    idx = torch.as_tensor(rng.integers(0, n_keys, rows).astype(np.int32), device=dev)
    bh = torch.as_tensor(rng.integers(0, 256, (rows, 2 * digits)).astype(np.uint8), device=dev)
    nib = torch.as_tensor(rng.integers(0, 16, (4 * digits, rows)).astype(np.uint8), device=dev)
    return (bh, nib, idx, ukey, rns.consts(digits, n_bits, dev))


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", default="", help="comma-separated rows per block to build besides the library's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_k2_rows: needs one CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    base = _build.library()
    built = cuda_rns.kernel_attrs()["pow"]["rows_per_block"]
    libs = {built: base}
    for r in sorted({int(x) for x in args.rows.split(",") if x} - {built}):
        libs[r] = _build.load(f"bftkv_kernels_rows{r}",
                              os.path.join(os.path.dirname(_build.BUILD_DIR), f"kernels_rows{r}"),
                              defines=(f"RNS_POW_ROWS={r}",))
    variants = {}
    attrs = {}
    for r, lib in libs.items():
        def pow_with(*a, lib=lib):
            _build._lib = lib  # the wrappers launch through _build.library()
            try:
                return cuda_rns.pow_cuda(*a)
            finally:
                _build._lib = base
        _build._lib = lib
        attrs[f"rows{r}"] = cuda_rns.kernel_attrs()["pow"]
        _build._lib = base
        variants[f"rows{r}"] = pow_with
    order = list(variants)
    out = {"built_rows": built, "attrs": attrs, "shapes": []}
    ok = True
    for digits, n_bits, t in SHAPES:
        a = _operands(digits, n_bits, t, 8, dev, seed=digits + t)
        plain = rns._pow_kernel(a[4], a[0], a[1], rns.gather_key(a[3], a[2]))
        rec = {"k": a[4].k, "digits": digits, "rows": t, "ms": {}, "errors": {}, "bit_identical": {}}
        live = []
        for name in order:
            try:
                got = variants[name](*a)
                torch.cuda.synchronize()
            except RuntimeError as e:
                rec["errors"][name] = str(e)
                continue
            same = torch.equal(got.long(), plain)
            rec["bit_identical"][name] = same
            ok = ok and same
            live.append(name)
        del plain
        for name in live + live[::-1]:
            rec["ms"].setdefault(name, []).append(_ms(lambda: variants[name](*a)))
        out["shapes"].append(rec)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(json.dumps(out), flush=True)
    if not ok:
        print("time_k2_rows: a K2 variant disagrees with the plain version", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
