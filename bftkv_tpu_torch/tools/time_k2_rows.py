"""Times K2 (``rns_pow_kernel``) at 2 and at 4 rows per block on one GPU.

The library builds K2 at 2 rows per block (``RNS_POW_ROWS`` in
``ops/csrc/rns_chain.cu``), the most that fits the card's shared memory
at 2048-bit moduli.  This script builds a second copy at 4 rows per block
(``-DRNS_POW_ROWS=4``, under ``bftkv_tpu_torch/_build/kernels_pow4/``)
and times both on the same seeded operands of the RNS sign shape (k=94,
64 digits: 1024-bit CRT halves) at T=512 and T=4096, interleaved
(2, 4, 4, 2 rows) by CUDA events.  Both must agree with each other and
with the plain version bit for bit.  At k=188 the 4-row copy must refuse
to launch, naming the byte count.

Run from the repository root:  python3 -m bftkv_tpu_torch.tools.time_k2_rows
It prints one JSON object, with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

from bftkv_tpu_torch.ops import _build, cuda_rns, rns

REPS = 10


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
    if not torch.cuda.is_available():
        print("time_k2_rows: needs one CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    libs = {
        2: _build.library(),
        4: _build.load("bftkv_kernels_pow4",
                       os.path.join(os.path.dirname(_build.BUILD_DIR), "kernels_pow4"),
                       defines=("RNS_POW_ROWS=4",)),
    }

    def pow_with(rows, args):
        _build._lib = libs[rows]  # the wrappers launch through _build.library()
        try:
            return cuda_rns.pow_cuda(*args)
        finally:
            _build._lib = libs[2]

    attrs = {}
    for rows in (2, 4):
        _build._lib = libs[rows]
        attrs[rows] = cuda_rns.kernel_attrs()["pow"]
    _build._lib = libs[2]

    out = {"rows_attrs": {str(r): a for r, a in attrs.items()}, "k94": []}
    for t in (512, 4096):
        args = _operands(64, 1024, t, 128, dev, seed=94 + t)
        got = {r: pow_with(r, args) for r in (2, 4)}
        plain = rns._pow_kernel(args[4], args[0], args[1], rns.gather_key(args[3], args[2]))
        same = torch.equal(got[2], got[4]) and torch.equal(got[2].long(), plain)
        del plain
        times = {2: [], 4: []}
        for r in (2, 4, 4, 2):
            times[r].append(_ms(lambda: pow_with(r, args)))
        out["k94"].append({"rows": t, "bit_identical": same,
                           "ms_2rows": times[2], "ms_4rows": times[4]})
        if not same:
            print(json.dumps(out), flush=True)
            print("time_k2_rows: the 2-row and 4-row kernels disagree", file=sys.stderr)
            return 1
    args = _operands(128, 2048, 64, 8, dev, seed=188)
    try:
        pow_with(4, args)
        out["k188_4rows"] = "launched"
    except RuntimeError as e:
        out["k188_4rows"] = str(e)
    out["k188_2rows_ms"] = _ms(lambda: pow_with(2, args))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0 if "needs" in out["k188_4rows"] else 1


if __name__ == "__main__":
    sys.exit(main())
