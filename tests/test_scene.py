import numpy as np

from pim.geom.cornell import build_cornell_box
from pim.render.scene import build_scene


def test_cornell_scene_build():
    ents, pool = build_cornell_box("boxes")
    meta, arrays, lights = build_scene(ents, pool, backend="brute")

    # 9 boxes * 12 tris
    assert meta.tri_count == 9 * 12
    assert meta.mat_count == 9
    # only the light box is emissive (12 tris)
    assert meta.emissive_count == 12
    assert np.asarray(arrays.emit_to_tri_f).shape == (1, 12)

    # interior cells active, e.g. center cell; the grid spans ~10m/1.5
    g = meta.grid_len
    active = np.asarray(arrays.cell_active)
    assert active.sum() > 0.5 * g  # the box interior dominates the bounds

    # light pdfs: rows for active cells should favor visibility
    pdf = np.asarray(lights.pdf)
    assert pdf.shape == (g, 12)
    assert np.isfinite(pdf).all()
    # at least the center cell can see the ceiling light
    cdf = np.asarray(lights.cdf)
    assert (cdf[:, -1] <= 1.0 + 1e-5).all()


def test_cornell_materials_roundtrip():
    ents, pool = build_cornell_box("boxes")
    meta, arrays, _ = build_scene(ents, pool, backend="brute")
    planes = np.asarray(arrays.atlas_planes)  # [4, H*W]
    rec = np.asarray(arrays.tex_rec_t).astype(np.int64)  # [5, Ntex]
    # light material albedo is ~1.0 after the sRGB8 round trip
    light_mat = [i for i, m in enumerate(ents.materials) if m.flags & 1][0]
    at = ents.materials[light_mat].albedo_tex
    x0, y0, w, h, stride = rec[:, at]
    np.testing.assert_allclose(planes[:3, y0 * stride + x0], 1.0, atol=0.02)
    # wall albedo ~0.9/0.1 after round trip
    wall_mat = ents.materials[0]
    x0, y0, w, h, stride = rec[:, wall_mat.albedo_tex]
    np.testing.assert_allclose(planes[:3, y0 * stride + x0], 0.9, atol=0.02)
