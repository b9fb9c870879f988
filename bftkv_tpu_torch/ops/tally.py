"""Batched quorum tallies (counterpart of ``bftkv_tpu/ops/tally.py``).

A whole batch of candidate sets (the signer sets of many concurrent
reads, per-request ack sets) tallies against every quorum clique at
once: ``membership`` is ``(nqc, U)`` (one row per quorum clique over a
node universe of size U), ``candidates`` is ``(batch, U)``; a nonzero
entry marks a member.  The predicates are the reference's
(``quorum/wotqs/wotqs.go:144-206`` in the system it was modelled on),
vectorized over the batch.

Exact by construction: :func:`counts` is one float32 matrix product of
0/1 entries.  0 and 1 are exact in float32 and in TF32 (which CUDA may
use for float32 products), and every partial sum is an integer no larger
than U, exact in float32's 24-bit significand; a universe wider than
2^24 − 1 nodes is summed in slices of that width, each exact, added in
int64.  So the counts equal the reference's int32 einsum bit for bit,
on the card as on the CPU.  No hand kernel: the reference computes this
in XLA outside any Pallas kernel.

Each function runs on ``device`` (resolved by
:mod:`bftkv_tpu_torch.device`: ``cuda:0`` unless the caller asks for
``"cpu"``) or, when the caller names none and the membership rows are a
tensor, on that tensor's device; the other inputs follow it.
"""

from __future__ import annotations

import torch

from bftkv_tpu_torch import device as devmod

__all__ = [
    "counts",
    "equivocation_pairs",
    "is_quorum_batch",
    "is_sufficient_batch",
    "is_threshold_batch",
    "reject_batch",
]

#: Widest slice of the universe one float32 product sums exactly.
_EXACT_F32 = (1 << 24) - 1


def _device_of(x, device) -> torch.device:
    """``x``'s device for a tensor when the caller names none, else the
    resolved ``device``."""
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return devmod.resolve(device)


def _members(x, dev: torch.device) -> torch.Tensor:
    """0/1 float32 rows (nonzero = member) on ``dev``."""
    return (torch.as_tensor(x, device=dev) != 0).to(torch.float32)


def counts(membership, candidates, *, device=None) -> torch.Tensor:
    """Intersection sizes, ``(batch, nqc)`` int32, on the membership's
    device (or ``device``)."""
    dev = _device_of(membership, device)
    m = _members(membership, dev)
    c = _members(candidates, dev)
    u = m.shape[1]
    total = None
    for lo in range(0, max(u, 1), _EXACT_F32):
        part = (c[:, lo : lo + _EXACT_F32] @ m[:, lo : lo + _EXACT_F32].T).to(torch.int64)
        total = part if total is None else total + part
    return total.to(torch.int32)


def _per_clique(x, like: torch.Tensor) -> torch.Tensor:
    """A (nqc,) bound as a (1, nqc) int64 row on ``like``'s device."""
    return torch.as_tensor(x, device=like.device).to(torch.int64).reshape(1, -1)


def is_threshold_batch(membership, candidates, threshold, *, device=None) -> torch.Tensor:
    """(batch,) bool: every clique with a positive threshold meets it (and
    there is at least one clique)."""
    c = counts(membership, candidates, device=device)
    th = _per_clique(threshold, c)
    ok = (th <= 0) | (c >= th)
    return ok.all(dim=-1) & (c.shape[1] > 0)


def is_quorum_batch(membership, candidates, f, min_, *, device=None) -> torch.Tensor:
    """(batch,) bool: every clique with f > 0 holds at least ``min_`` of the
    candidates (and there is at least one clique)."""
    c = counts(membership, candidates, device=device)
    ok = (_per_clique(f, c) <= 0) | (c >= _per_clique(min_, c))
    return ok.all(dim=-1) & (c.shape[1] > 0)


def is_sufficient_batch(membership, candidates, suff, *, device=None) -> torch.Tensor:
    """(batch,) bool: some clique with suff > 0 holds at least suff."""
    c = counts(membership, candidates, device=device)
    s = _per_clique(suff, c)
    return ((s > 0) & (c >= s)).any(dim=-1)


def reject_batch(membership, candidates, f, *, device=None) -> torch.Tensor:
    """(batch,) bool: every clique has f > 0 and more than f of the
    candidates (vacuously true with no cliques)."""
    c = counts(membership, candidates, device=device)
    fv = _per_clique(f, c)
    return ((fv > 0) & (c > fv)).all(dim=-1)


def equivocation_pairs(signer_sets, *, device=None) -> torch.Tensor:
    """``(U,)`` bool mask of the nodes present in more than one row of
    ``signer_sets`` ``(nvalues, U)``: one row per distinct value observed
    at one timestamp, marking which nodes signed it — the signers that
    signed two different values at the same timestamp."""
    dev = _device_of(signer_sets, device)
    return (torch.as_tensor(signer_sets, device=dev) != 0).sum(dim=0) >= 2
