"""The frozen work model reproduces the bounds of the port's kernel table."""

from __future__ import annotations

import pytest

from portbench.workmodel import Launch, bound_s, bytes_of, ops_of


def test_k1_bound_at_t4096():
    # PERF.md's kernel table: K1, T=4096, k=188, bound 0.018366 ms (operations).
    launch = Launch("k1", 4096, 2048, 17, 64)
    assert bound_s(launch) * 1e3 == pytest.approx(0.018366, rel=1e-4)
    assert ops_of(launch) / 1.979e15 > bytes_of(launch) / 3.35e12


def test_k2_bound_at_t8192():
    # K2, T=8192, k=94 (1024-bit CRT halves, 1024-bit exponents), 0.57573 ms.
    launch = Launch("k2", 8192, 1024, 1024, 128)
    assert bound_s(launch) * 1e3 == pytest.approx(0.57573, rel=1e-4)


def test_work_scales_with_live_rows_and_exponent():
    a, b = Launch("k2", 100, 1024, 1024), Launch("k2", 200, 1024, 1024)
    assert ops_of(b) == 2 * ops_of(a)
    assert ops_of(Launch("k2", 100, 1024, 512)) < ops_of(a)


def test_unknown_width_is_refused():
    with pytest.raises(KeyError):
        ops_of(Launch("k1", 1, 4096))
