"""The port's quorum tallies (``bftkv_tpu_torch/ops/tally.py``) against the
reference's jitted ones (``bftkv_tpu/ops/tally.py``), bit for bit, on
seeded random membership matrices and the edge cases: no cliques, f ≤ 0,
threshold ≤ 0, suff ≤ 0, an empty universe."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bftkv_tpu.ops import tally as ref
from bftkv_tpu_torch.ops import tally

# (batch, nqc, U, membership density)
SHAPES = [(16, 4, 10, 0.5), (33, 7, 64, 0.3), (5, 1, 3, 0.7), (9, 12, 129, 0.1), (4, 0, 6, 0.5)]


def _case(shape, seed: int):
    batch, nqc, u, p = shape
    rng = np.random.default_rng(seed)
    membership = rng.random((nqc, u)) < p
    candidates = rng.random((batch, u)) < 0.6
    # Bounds around the counts, zero and negative ones included.
    bounds = lambda: rng.integers(-2, max(3, u // 2), size=nqc).astype(np.int32)
    return membership, candidates, bounds(), bounds(), bounds()


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s[:3])))
def test_counts_and_predicates_equal_the_reference(shape):
    membership, candidates, f, min_, suff = _case(shape, seed=sum(shape[:3]))
    got = tally.counts(membership, candidates, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), _np(ref.counts(membership, candidates)))
    pairs = [
        (tally.is_threshold_batch(membership, candidates, f, device="cpu"),
         ref.is_threshold_batch(membership, candidates, f)),
        (tally.is_quorum_batch(membership, candidates, f, min_, device="cpu"),
         ref.is_quorum_batch(membership, candidates, f, min_)),
        (tally.is_sufficient_batch(membership, candidates, suff, device="cpu"),
         ref.is_sufficient_batch(membership, candidates, suff)),
        (tally.reject_batch(membership, candidates, f, device="cpu"),
         ref.reject_batch(membership, candidates, f)),
    ]
    for mine, theirs in pairs:
        assert mine.dtype == torch.bool and mine.shape == (shape[0],)
        np.testing.assert_array_equal(_np(mine), _np(theirs))


@pytest.mark.parametrize("bound", [0, -1])
def test_nonpositive_bounds_are_the_references(bound):
    """f ≤ 0 makes a clique vacuous for quorum and fails it for reject;
    threshold ≤ 0 and suff ≤ 0 likewise."""
    membership, candidates, *_ = _case((12, 5, 20, 0.5), seed=3)
    b = np.full(5, bound, dtype=np.int32)
    for name, args in (
        ("is_threshold_batch", (b,)), ("is_quorum_batch", (b, b + 7)),
        ("is_sufficient_batch", (b,)), ("reject_batch", (b,)),
    ):
        mine = getattr(tally, name)(membership, candidates, *args, device="cpu")
        np.testing.assert_array_equal(_np(mine), _np(getattr(ref, name)(membership, candidates, *args)))
    assert tally.is_threshold_batch(membership, candidates, b, device="cpu").all()
    assert not tally.is_sufficient_batch(membership, candidates, b, device="cpu").any()
    assert not tally.reject_batch(membership, candidates, b, device="cpu").any()


def test_no_cliques():
    membership = np.zeros((0, 8), dtype=bool)
    candidates = np.ones((3, 8), dtype=bool)
    none = np.zeros(0, dtype=np.int32)
    assert tally.counts(membership, candidates, device="cpu").shape == (3, 0)
    for name, args, want in (
        ("is_threshold_batch", (none,), False), ("is_quorum_batch", (none, none), False),
        ("is_sufficient_batch", (none,), False), ("reject_batch", (none,), True),
    ):
        mine = getattr(tally, name)(membership, candidates, *args, device="cpu")
        theirs = getattr(ref, name)(membership, candidates, *args)
        np.testing.assert_array_equal(_np(mine), _np(theirs))
        assert _np(mine).tolist() == [want] * 3


def test_empty_universe():
    membership = np.zeros((2, 0), dtype=bool)
    candidates = np.zeros((4, 0), dtype=bool)
    np.testing.assert_array_equal(
        _np(tally.counts(membership, candidates, device="cpu")), _np(ref.counts(membership, candidates)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_equivocation_pairs_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    signer_sets = rng.random((1 + seed * 3, 40)) < 0.2
    mine = tally.equivocation_pairs(signer_sets, device="cpu")
    assert mine.dtype == torch.bool and mine.shape == (40,)
    np.testing.assert_array_equal(_np(mine), _np(ref.equivocation_pairs(signer_sets)))


def test_tensors_stay_on_their_device_and_wide_universes_sum_in_exact_slices(monkeypatch):
    """Tensor inputs run where they are (no device argument); a universe
    wider than one exact float32 slice is summed slice by slice — shown
    with the slice narrowed to 7 nodes."""
    membership, candidates, f, min_, _ = _case((10, 6, 50, 0.5), seed=9)
    want = _np(ref.counts(membership, candidates))
    m_t, c_t = torch.from_numpy(membership), torch.from_numpy(candidates)
    np.testing.assert_array_equal(_np(tally.counts(m_t, c_t)), want)
    np.testing.assert_array_equal(_np(tally.counts(m_t, candidates)), want)  # follows m_t
    monkeypatch.setattr(tally, "_EXACT_F32", 7)
    np.testing.assert_array_equal(_np(tally.counts(m_t, c_t)), want)
    np.testing.assert_array_equal(
        _np(tally.is_quorum_batch(m_t, c_t, f, min_)),
        _np(ref.is_quorum_batch(membership, candidates, f, min_)),
    )
