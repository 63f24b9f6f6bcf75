"""Reflection-probe cubemap tests (ref src/rendering/cubemap.{c,h})."""

import jax.numpy as jnp
import numpy as np
import pytest

from pim.render import cubemap as cmaps


def test_mip_chain_shapes():
    cm = cmaps.cubemap_new(16)
    assert cm.size == 16
    assert cm.mip_count == 5  # 16,8,4,2,1
    assert cm.mips[0].shape == (6, 16, 16, 3)
    assert cm.mips[-1].shape == (6, 1, 1, 3)


def test_calc_dirs_unit_and_face_aligned():
    n = 6 * 8 * 8
    dirs = np.asarray(cmaps.calc_dirs_jittered(8, jnp.zeros((n, 2))))
    assert np.allclose(np.linalg.norm(dirs, axis=-1), 1.0, atol=1e-5)
    # center texels of face 0 (+X) should have dominant +x component
    face0 = dirs[: 8 * 8].reshape(8, 8, 3)
    assert np.all(face0[3:5, 3:5, 0] > 0.55)


@pytest.mark.slow
def test_prefilter_constant_env_is_identity():
    # a constant cubemap must prefilter to the same constant at every mip
    cm = cmaps.cubemap_new(8)
    cm = cm._replace(color=jnp.full((6, 8, 8, 3), 2.5))
    cm = cmaps.convolve(cm, sample_count=8, weight=1.0)
    for m in range(cm.mip_count):
        np.testing.assert_allclose(np.asarray(cm.mips[m]), 2.5, rtol=1e-3)


def test_read_convolved_trilinear_between_mips():
    cm = cmaps.cubemap_new(8)
    mips = list(cm.mips)
    mips[0] = jnp.zeros_like(mips[0])
    mips[1] = jnp.ones_like(mips[1]) * 4.0
    cm = cm._replace(mips=tuple(mips))
    d = jnp.asarray([[1.0, 0.0, 0.0]])
    max_mip = float(cm.mip_count - 1)
    # roughness such that mip = 0.5
    r_half = 0.5 / max_mip
    out = np.asarray(cmaps.read_convolved(cm, d, r_half))
    np.testing.assert_allclose(out, 2.0, atol=1e-4)
    out0 = np.asarray(cmaps.read_convolved(cm, d, 0.0))
    np.testing.assert_allclose(out0, 0.0, atol=1e-6)


@pytest.mark.slow
def test_progressive_bake_converges_on_cornell():
    from pim.geom.cornell import build_cornell_box
    from pim.render.scene import build_scene

    ents, pool = build_cornell_box("boxes")
    meta, arrays, lights = build_scene(ents, pool, backend="brute")

    reg = cmaps.CubemapRegistry()
    reg.add("probe", 8)
    for _ in range(2):
        cm = reg.bake("probe", meta, arrays, lights, [0.0, 0.0, 0.0],
                      max_bounces=2, convolve_samples=4)
    col = np.asarray(cm.color)
    assert np.all(np.isfinite(col))
    assert col.max() > 0.0  # the light panel is visible from the center
    assert np.all(np.isfinite(np.asarray(cm.mips[2])))
