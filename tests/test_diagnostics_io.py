import numpy as np
import pytest

import jax.numpy as jnp

from nbody.io import read_input, SceneFormatError
from nbody.simulate import simulate
from nbody.utils.diagnostics import (total_energy, total_momentum,
                                         kinetic_energy)
from nbody.models.plummer import plummer_scene


def _write(tmp_path, text):
    p = tmp_path / "case.in"
    p.write_text(text)
    return str(p)


def test_bad_header_rejected(tmp_path):
    with pytest.raises(SceneFormatError, match="missing header"):
        read_input(_write(tmp_path, "1 0"))


def test_token_count_mismatch(tmp_path):
    with pytest.raises(SceneFormatError, match="expected"):
        read_input(_write(tmp_path, "2 0 1\n0 0 0 0 0 0 1 star\n"))


def test_out_of_range_indices(tmp_path):
    body = "0 0 0 0 0 0 1 star\n"
    with pytest.raises(SceneFormatError, match="out of range"):
        read_input(_write(tmp_path, "1 0 3\n" + body))


def test_nonfinite_rejected(tmp_path):
    body1 = "0 0 0 0 0 0 nan star\n"
    body2 = "1 0 0 0 0 0 1 planet\n"
    with pytest.raises(SceneFormatError, match="non-finite"):
        read_input(_write(tmp_path, "2 1 0\n" + body1 + body2))


def test_momentum_conserved_exactly_enough():
    """Pairwise forces are antisymmetric; total momentum of an isolated
    system should be conserved to fp roundoff over a short march."""
    import dataclasses
    from nbody.io import Scene

    q, v, m = plummer_scene(64, seed=3)
    scene = Scene(n=64, planet=0, asteroid=1, q=q, v=v, m=m,
                  types=["star"] * 64, device_idx=np.asarray([], dtype=np.int64))
    p0 = np.asarray(total_momentum(jnp.asarray(v), jnp.asarray(m)))
    out = simulate(scene, n_steps=20, chunk=20)
    p1 = np.asarray(total_momentum(jnp.asarray(out.v), jnp.asarray(m)))
    # roundoff scale: the summands |m_i v_i| (the total cancels to ~0)
    scale = float(np.abs(m[:, None] * v).sum())
    assert np.abs(p1 - p0).max() < 1e-12 * scale


def test_energy_bounded_on_plummer():
    import dataclasses
    from nbody.io import Scene

    q, v, m = plummer_scene(64, seed=4)
    scene = Scene(n=64, planet=0, asteroid=1, q=q, v=v, m=m,
                  types=["star"] * 64, device_idx=np.asarray([], dtype=np.int64))
    G, eps = 6.674e-11, 1e-3
    e0 = float(total_energy(jnp.asarray(q), jnp.asarray(v), jnp.asarray(m),
                            G=G, eps=eps))
    out = simulate(scene, n_steps=50, chunk=50)
    e1 = float(total_energy(jnp.asarray(out.q), jnp.asarray(out.v),
                            jnp.asarray(m), G=G, eps=eps))
    assert abs(e1 - e0) / abs(e0) < 0.05


def test_leapfrog_conserves_energy_better_than_euler():
    from nbody.io import Scene
    from nbody.utils.diagnostics import total_energy
    from nbody.simulate import simulate
    import jax.numpy as jnp

    q, v, m = plummer_scene(48, seed=7)
    scene = Scene(n=48, planet=0, asteroid=1, q=q, v=v, m=m,
                  types=["star"] * 48,
                  device_idx=np.asarray([], dtype=np.int64))
    G, eps = 6.674e-11, 1e-3
    e0 = float(total_energy(jnp.asarray(q), jnp.asarray(v), jnp.asarray(m),
                            G=G, eps=eps))

    def drift(integrator):
        out = simulate(scene, n_steps=200, chunk=200, integrator=integrator)
        e = float(total_energy(jnp.asarray(out.q), jnp.asarray(out.v),
                               jnp.asarray(m), G=G, eps=eps))
        return abs(e - e0) / abs(e0)

    d_euler = drift("euler")
    d_leap = drift("leapfrog")
    assert d_leap < d_euler
    assert d_leap < 0.02
