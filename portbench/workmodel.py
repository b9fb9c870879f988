"""The frozen work model of the RNS kernels K1 (verify), K2 (pow) and K5
(P-256 scalar mult).

A launch's work is counted from what its inputs need: the live rows (the
padding rows the program adds are not counted), the modulus width and,
for K2, the exponent's bits.  The per-row counts are those of the
implementation that stood when the benchmark was defined, with its RNS
base size ``k`` and its 16-bit digit count frozen here per modulus width,
so the roofline reads the same work whatever later implements it:

- an int8 tensor-core product of a 12-bit residue pair counts 6
  operations, a multiply-accumulate of the digit conversion 4;
- K1, s^65537 mod N against the encoded message:
  ``4·2·(2·digits)·(2k+1) + 6·19·2k(k+1)`` per row (two conversions in,
  19 Montgomery products);
- K2, base^exp mod N with a 4-bit window:
  ``4·(2·digits)·(2k+1) + 6·(17 + 5·windows)·2k(k+1)`` per row, with
  ``windows = ceil(exp_bits / 4)`` (16 table products and one conversion
  product, then 4 squarings and 1 product a window);
- K5, k·P on P-256 with 4-bit windows over P-256's RNS base of ``k = 27``:
  ``6·3920·2k(k+1)`` per point, its 3920 Montgomery products being 14
  table adds of 24 (16 of the add, 8 of the doubling it also evaluates),
  then 64 windows of 4 doublings (8 each) and one add of 24.

Bytes are each input read once and each output written once: the rows'
8-bit digit halves (and K2's exponent nibbles), a 4-byte key index and
the result, plus the distinct keys' int32 rows; for K5 a point's int32
Jacobian residues in (3 coordinates over 2k+1 channels), its 64 window
nibbles and its residues out (the curve's constant tables, a few KiB a
launch, are left out).  The bound of a launch is
the larger of operations over the int8 peak and bytes over the HBM rate
of one H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = ["EC_K", "EC_PRODUCTS", "HBM_BYTES_PER_S", "INT8_OPS_PER_S", "SHAPES", "Launch", "bound_s",
           "bytes_of", "ops_of"]

#: One H100 SXM: 1,979 TOP/s int8 dense, 3.35 TB/s HBM3.
INT8_OPS_PER_S = 1.979e15
HBM_BYTES_PER_S = 3.35e12

#: Modulus bits -> (16-bit digits, RNS base size k), frozen.
SHAPES = {1024: (64, 94), 2048: (128, 188)}
#: K5: P-256's RNS base size and the Montgomery products of one point, frozen.
EC_K = 27
EC_PRODUCTS = 14 * 24 + 64 * (4 * 8 + 24)


@dataclass(frozen=True)
class Launch:
    """One kernel launch as the hooks record it."""

    kernel: str  # "k1" (verify), "k2" (pow) or "k5" (P-256 scalar mult)
    rows: int  # live rows (K5: live points)
    mod_bits: int  # K5: 256
    exp_bits: int = 17  # K1's exponent is 65537
    keys: int = 1  # distinct moduli of the launch


def _shape(mod_bits: int) -> tuple[int, int]:
    if mod_bits not in SHAPES:
        raise KeyError(f"no frozen RNS shape for {mod_bits}-bit moduli")
    return SHAPES[mod_bits]


def ops_of(launch: Launch) -> float:
    if launch.kernel == "k5":
        return float(6 * EC_PRODUCTS * 2 * EC_K * (EC_K + 1)) * launch.rows
    digits, k = _shape(launch.mod_bits)
    conv = 4 * (2 * digits) * (2 * k + 1)
    product = 6 * 2 * k * (k + 1)
    if launch.kernel == "k1":
        per_row = 2 * conv + 19 * product
    elif launch.kernel == "k2":
        windows = math.ceil(launch.exp_bits / 4)
        per_row = conv + (17 + 5 * windows) * product
    else:
        raise ValueError(f"unknown kernel {launch.kernel!r}")
    return float(per_row) * launch.rows


def bytes_of(launch: Launch) -> float:
    if launch.kernel == "k5":
        return float(2 * 3 * (2 * EC_K + 1) * 4 + 64) * launch.rows
    digits, k = _shape(launch.mod_bits)
    key_row = 4 * (7 * k + 2)  # n_all, n_r, neg_ninv_b, ninv_all, m2_all, m2_r
    if launch.kernel == "k1":
        per_row = 2 * (2 * digits) + 4 + 4  # sig and em halves, index, verdict
    else:
        per_row = 2 * digits + math.ceil(launch.exp_bits / 4) + 4 + 4 * k  # base, nibbles, index, σ
    return float(per_row) * launch.rows + float(key_row) * launch.keys


def bound_s(launch: Launch) -> float:
    """The least time one H100 could take for the launch."""
    return max(ops_of(launch) / INT8_OPS_PER_S, bytes_of(launch) / HBM_BYTES_PER_S)
