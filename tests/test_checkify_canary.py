"""Checkify canary: poisoned scenes must fail LOUDLY under pt_debug and
never silently corrupt a non-debug render (r3/r4 verdict ask; the
sanitizer analog of the reference's ASSERT density, SURVEY §5).

Three injections, each driven through the real RenderSystem frame loop:
  1. NaN texel in a wall albedo  -> pt_debug raises with a useful message
     (the non-debug path is ALLOWED to go NaN — that is exactly the
     silent poisoning the guard exists to catch).
  2. degenerate (zero-area, collinear) triangle -> shades cleanly in both
     modes (the intersectors reject |det| <= 1e-12 before dividing).
  3. zero-area emissive -> shades cleanly in both modes (a zero-area
     light emits zero power and must not NaN the NEE/MIS weights).
"""

import numpy as np
import pytest

from pim.core import cvars as cv
from pim.geom.cornell import build_cornell_box
from pim.geom.material import Material, MatFlag, TexturePool
from pim.geom.mesh import MeshData
from pim.render.render_system import RenderSystem


RES = 16


def _degenerate_mesh() -> MeshData:
    """One zero-area triangle: three collinear vertices, finite normals."""
    positions = np.array(
        [[0, 0, 0], [1, 1, 1], [2, 2, 2]], np.float32)
    normals = np.tile(np.array([[0, 1, 0]], np.float32), (3, 1))
    uvs = np.zeros((3, 2), np.float32)
    return MeshData(positions, normals, uvs)


def _fresh_rs(debug: bool) -> RenderSystem:
    cv.cv_pt_trace.set(True)
    cv.cv_exp_manual.set(True)
    cv.cv_exp_evoffset.set(5.0)
    cv.cv_pt_denoise.set(False)
    cv.cv_pt_debug.set(bool(debug))
    cv.cv_pt_spp.set(1)
    cv.cv_pt_max_bounces.set(2)
    rs = RenderSystem(width=RES, height=RES)
    rs.entities, rs.pool = build_cornell_box("boxes")
    rs.camera.reset()
    rs.camera.position = np.asarray([-4.0, 0.0, 4.0], np.float32)
    rs.camera.look_at([0.0, -1.0, 0.0])
    return rs


def _run_frames(rs: RenderSystem, n=2):
    for _ in range(n):
        rs.update()
    return np.asarray(rs.buffers.color)


def _poison_albedo_nan(rs: RenderSystem) -> None:
    """NaN the 1x1 flat albedo texel of the biggest wall material."""
    tex = rs.entities.materials[0].albedo_tex
    img = rs.pool.get(tex)
    img[0, 0, 0] = np.nan
    rs.entities.touch()  # force a scene rebuild with the poisoned pool


@pytest.fixture(autouse=True)
def _restore_cvars():
    yield
    cv.cv_pt_debug.set(False)
    cv.cv_pt_max_bounces.set(10)


@pytest.mark.slow
def test_clean_scene_debug_quiet():
    """The guard itself must not cry wolf: a clean render under pt_debug
    finishes and stays finite."""
    rs = _fresh_rs(debug=True)
    img = _run_frames(rs)
    assert np.isfinite(img).all()
    assert img.max() > 0.0


def test_nan_texel_raises_under_debug():
    rs = _fresh_rs(debug=True)
    _poison_albedo_nan(rs)
    with pytest.raises(Exception, match="pt_debug"):
        _run_frames(rs)


def test_nan_texel_silently_poisons_without_debug():
    """Documents WHY the guard exists: the fast path renders the poisoned
    scene without an error and the corruption lands in the buffer."""
    rs = _fresh_rs(debug=False)
    _poison_albedo_nan(rs)
    img = _run_frames(rs)
    assert not np.isfinite(img).all()


@pytest.mark.slow
def test_degenerate_triangle_shades_cleanly():
    for debug in (False, True):
        rs = _fresh_rs(debug=debug)
        i = rs.entities.add("degenerate")
        rs.entities.meshes[i] = _degenerate_mesh()
        rs.entities.materials[i] = rs.entities.materials[0]
        img = _run_frames(rs)
        assert np.isfinite(img).all(), f"debug={debug}"
        assert img.max() > 0.0


@pytest.mark.slow
def test_zero_area_emissive_shades_cleanly():
    for debug in (False, True):
        rs = _fresh_rs(debug=debug)
        pool = rs.pool
        mat = Material()
        mat.albedo_tex = pool.add_flat((1.0, 1.0, 1.0, 1.0))
        mat.rome_tex = pool.add_flat((0.9, 1.0, 0.0, 1.0))  # emission alpha 1
        mat.flags = MatFlag.EMISSIVE
        i = rs.entities.add("zero_area_light")
        rs.entities.meshes[i] = _degenerate_mesh()
        rs.entities.materials[i] = mat
        img = _run_frames(rs)
        assert np.isfinite(img).all(), f"debug={debug}"
