"""Operation and byte counts against hand counts at small shapes."""
import pytest

from benchmark import flops


def test_flash_fwd():
    d = flops.flash_fwd(n=4, m=6, m_valid=5, heads=2, dim=3)
    # q, out: 4 x 6 floats each; k, v: 6 x 6 each; 6 mask bytes
    assert d["bytes"] == 4 * (2 * 4 * 6 + 2 * 6 * 6) + 6
    # per (query, valid key, head): 3 FMAs for q.k and 3 for p v
    assert d["f32"] == 4 * 5 * 2 * (2 * 3 + 2 * 3)


def test_cdist_and_rank_major():
    d = flops.cdist(n=3, m=7, m_valid=4, c=2, k=1)
    assert d == {"bytes": 4 * (3 * 2 + 7 * 2) + 7 + 8 * 3,
                 "f32": 3 * 4 * 2 * 2}
    r = flops.rank_major(p=10, v2=2, live_rows=6)
    assert r == {"bytes": 4 * (30 + 10 + 4 + 10), "f32": 12 * 6 * 10}


def test_least_time_takes_the_larger_bound():
    assert flops.least_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert flops.least_s(0.0, 67e12) == pytest.approx(1.0)
    assert flops.bound_by(3.35e12, 1.0) == "bytes"
    assert flops.bound_by(1.0, 67e12) == "operations"


def test_dense_and_forward_scale():
    assert flops.dense(5, 3, 2) == 2 * 5 * 3 * 2 + 5 * 2
    a = flops.dpfm_forward(100, 50, 16, 8, 3)
    b = flops.dpfm_forward(200, 100, 16, 8, 3)
    assert 2 < b / a < 4        # linear layers x2, attention x4
