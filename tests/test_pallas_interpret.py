"""fp32 Triton force kernel (ops/pallas_forces.py), validated in interpret
mode on the CPU.

The compiled kernel runs on the GPU (chip_smoke.py phase 4, bench.py);
here the same kernel body runs interpreted, so the CPU suite covers the
blocking, the in-kernel j loop, the cross form and the zero-mass padding
of ragged sizes.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from nbody.ops.forces import pairwise_accel_fast
from nbody.ops.pallas_forces import pallas_accel, pallas_accel_cross

G, EPS = 6.674e-11, 1e-3


def _system(n, seed=0):
    rs = np.random.RandomState(seed)
    q = jnp.asarray(rs.randn(n, 3), jnp.float32)
    m = jnp.asarray(np.abs(rs.randn(n)) * 1e8, jnp.float32)
    return q, m


def _assert_close(a, a_ref):
    np.testing.assert_allclose(np.asarray(a), np.asarray(a_ref), rtol=2e-5,
                               atol=float(jnp.abs(a_ref).max()) * 1e-6)


@pytest.mark.parametrize("tile_i,tile_j", [(32, 64), (64, 32), (128, 128)])
def test_kernel_matches_xla(tile_i, tile_j):
    q, m = _system(128)
    a = pallas_accel(q, G * m, eps=EPS, block_i=tile_i, block_j=tile_j,
                     interpret=True)
    assert a.shape == (128, 3) and a.dtype == jnp.float32
    _assert_close(a, pairwise_accel_fast(q, m, G=G, eps=EPS))


def test_zero_mass_padding_contributes_nothing():
    """Zero-mass bodies add exactly 0 wherever they sit: two paddings at
    different positions give the same bits, and both agree with the
    unpadded system. (Bit equality with the unpadded call is not asked:
    a different j-loop trip count lets XLA:CPU's interpreter contract
    mul+add differently.)"""
    n = 64
    rs = np.random.RandomState(1)
    q = rs.randn(n, 3).astype(np.float32)
    gm = (np.abs(rs.randn(n)) * 1e-3).astype(np.float32)
    gm[n // 2:] = 0.0            # padded half
    q[n // 2:] = 0.0             # coincident pad bodies at the origin
    q_far = q.copy()
    q_far[n // 2:] = rs.randn(n // 2, 3) * 1e3   # pads scattered far away
    kw = dict(eps=EPS, block_i=32, block_j=32, interpret=True)
    a = pallas_accel(jnp.asarray(q), jnp.asarray(gm), **kw)
    a_far = pallas_accel(jnp.asarray(q_far), jnp.asarray(gm), **kw)
    a2 = pallas_accel(jnp.asarray(q[:n // 2]), jnp.asarray(gm[:n // 2]),
                      **kw)
    assert np.isfinite(np.asarray(a)).all()
    np.testing.assert_array_equal(np.asarray(a)[:n // 2],
                                  np.asarray(a_far)[:n // 2])
    np.testing.assert_allclose(np.asarray(a)[:n // 2], np.asarray(a2),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("ni,nj", [(32, 128), (100, 64)])
def test_cross_form_matches_xla(ni, nj):
    """Rows from one set against sources from another (the ring's
    building block): equal to those rows of the all-pairs force when the
    rows join the sources as zero-mass bodies."""
    qj, m = _system(nj, seed=2)
    rs = np.random.RandomState(3)
    qi = jnp.asarray(rs.randn(ni, 3), jnp.float32)
    a = pallas_accel_cross(qi, qj, G * m, eps=EPS, block_i=32, block_j=32,
                           interpret=True)
    assert a.shape == (ni, 3)
    q_all = jnp.concatenate([qj, qi])
    m_all = jnp.concatenate([m, jnp.zeros((ni,), jnp.float32)])
    _assert_close(a, pairwise_accel_fast(q_all, m_all, G=G, eps=EPS)[nj:])


@pytest.mark.parametrize("n", [1, 37, 130])
def test_ragged_n_padded_to_block(n):
    """n not a multiple of the blocks: both sides are padded with zero-mass
    bodies and the padded rows dropped, with no effect on the real rows."""
    q, m = _system(n, seed=4)
    a = pallas_accel(q, G * m, eps=EPS, block_i=32, block_j=64,
                     interpret=True)
    assert a.shape == (n, 3)
    _assert_close(a, pairwise_accel_fast(q, m, G=G, eps=EPS))
