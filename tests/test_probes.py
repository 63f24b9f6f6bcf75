"""Light-probe (ambient cube + L1 SH) fit and workflow tests.

Ref: AmbCube_Bake traces Pt_RayGen rays and folds them progressively
(the reference's src/math/ambcube.c:5-32); sh.h provides the L1 basis.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pim.geom.cornell import build_cornell_box
from pim.render.probes import (
    LightProbe,
    probe_bake_step,
    probe_from_crate_entry,
    probe_irradiance,
    probe_new,
    probe_radiance,
    probe_sh_irradiance,
    probe_to_crate_entry,
)
from pim.render.scene import build_scene


@pytest.fixture(scope="module")
def cornell_scene():
    ents, pool = build_cornell_box("boxes")
    return build_scene(ents, pool, backend="brute")


def test_sh_projection_recovers_analytic_field():
    """Projecting an exact L1 field from uniform samples recovers it."""
    from pim.math.sh import sh_l1_eval, sh_l1_project

    rng = np.random.default_rng(0)
    d = rng.normal(size=(20000, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d.astype(np.float32))
    coeffs = jnp.asarray(rng.uniform(-1, 1, (4, 3)).astype(np.float32))
    radiance = sh_l1_eval(coeffs, d)
    fit = sh_l1_project(d, radiance)
    np.testing.assert_allclose(np.asarray(fit), np.asarray(coeffs),
                               atol=0.05)


def test_probe_bake_sees_cornell_walls(cornell_scene):
    """A probe at the cornell center: the ±x irradiance leans toward the
    red/green wall tints and everything is finite and positive."""
    meta, arrays, lights = cornell_scene
    probe = probe_new([0.0, 0.0, 0.0])
    for _ in range(2):
        probe = probe_bake_step(meta, arrays, lights, probe,
                                samples=1024, max_bounces=2)
    assert int(probe.sample_count) == 2

    axes = np.eye(3, dtype=np.float32)
    cube = np.asarray(probe_irradiance(probe, jnp.asarray(
        np.vstack([axes, -axes]))))
    assert np.all(np.isfinite(cube)) and np.all(cube >= 0)
    # cornell walls: +x face red-dominant, -x green-dominant, +y is the
    # bright ceiling light (build_cornell_box parity with CreateBox,
    # render_system.c:1072-1110; measured faces r4)
    px, py, nx = cube[0], cube[1], cube[3]
    assert px[0] > px[1] * 1.05, px
    assert nx[1] > nx[0] * 1.05, nx
    assert py.min() > 5.0 * max(px.max(), nx.max()), (py, px, nx)

    # the SH fit of the same rays agrees with the cube on broad scale
    sh = np.asarray(probe_sh_irradiance(probe, jnp.asarray(np.vstack(
        [axes, -axes]))))
    assert np.all(np.isfinite(sh))
    np.testing.assert_allclose(sh.mean(), cube.mean(), rtol=0.5)


def test_probe_crate_round_trip(cornell_scene):
    meta, arrays, lights = cornell_scene
    probe = probe_bake_step(meta, arrays, lights, probe_new([0, 0, 0]),
                            samples=256, max_bounces=2)
    back = probe_from_crate_entry(probe_to_crate_entry(probe))
    for f in LightProbe._fields:
        np.testing.assert_array_equal(np.asarray(getattr(probe, f)),
                                      np.asarray(getattr(back, f)))


def test_probe_radiance_eval_shape():
    probe = probe_new([0, 0, 0])._replace(
        sh=jnp.asarray(np.random.default_rng(1).uniform(
            0, 1, (4, 3)).astype(np.float32)))
    out = probe_radiance(probe, np.asarray([[0, 1, 0]], np.float32))
    assert out.shape == (1, 3)
