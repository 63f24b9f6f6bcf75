"""glTF import/export round-trip + procedural map pipeline tests.

Covers the importer paths the reference exercises on real assets
(gltf_model.c:105-660): node TRS instantiation, de-indexing to flat soup,
baseColor/MR/normal texture import with colorspace handling, ROME packing,
and material flags from names — plus the exporter that materializes
procedural maps as on-disk assets.
"""

import os

import numpy as np
import pytest

from pim.geom.cornell import build_cornell_box
from pim.geom.entities import flatten
from pim.geom.gltf import load_gltf_scene, save_gltf_scene
from pim.geom.maps import build_map_scene, export_map
from pim.geom.material import MatFlag


def _small_map():
    return build_map_scene(rooms=(1, 2), spheres_per_room=2, sphere_steps=8,
                           tex_size=32)


def _assert_scene_roundtrip(ents, pool, ents2, pool2):
    f, f2 = flatten(ents), flatten(ents2)
    assert f.positions.shape == f2.positions.shape
    np.testing.assert_allclose(f.positions, f2.positions, atol=1e-4)
    np.testing.assert_allclose(f.normals, f2.normals, atol=1e-3)
    np.testing.assert_allclose(f.uvs, f2.uvs, atol=1e-6)
    # per-triangle material flags and ior survive
    fl = np.array([int(f.materials[m].flags) for m in f.mat_ids])
    fl2 = np.array([int(f2.materials[m].flags) for m in f2.mat_ids])
    np.testing.assert_array_equal(fl, fl2)
    io = np.array([f.materials[m].ior for m in f.mat_ids])
    io2 = np.array([f2.materials[m].ior for m in f2.mat_ids])
    np.testing.assert_allclose(io, io2)
    # texture content survives within 8-bit quantization
    for m, m2 in zip(f.materials, f2.materials):
        img = pool.get(m.albedo_tex)
        img2 = pool2.get(m2.albedo_tex)
        assert img.shape == img2.shape
        np.testing.assert_allclose(img, img2, atol=0.02)
        rome = pool.get(m.rome_tex)
        rome2 = pool2.get(m2.rome_tex)
        assert rome.shape == rome2.shape
        # roughness/metallic channels; occlusion is forced to 1 on import
        np.testing.assert_allclose(rome[..., 0], rome2[..., 0], atol=0.02)
        np.testing.assert_allclose(rome[..., 2], rome2[..., 2], atol=0.02)


def test_map_gltf_roundtrip(tmp_path):
    ents, pool = _small_map()
    path = str(tmp_path / "m.gltf")
    save_gltf_scene(ents, pool, path)
    # external .bin + .png siblings were written
    assert os.path.exists(str(tmp_path / "m.bin"))
    assert any(n.endswith(".png") for n in os.listdir(tmp_path))
    ents2, pool2 = load_gltf_scene(path)
    _assert_scene_roundtrip(ents, pool, ents2, pool2)


def test_map_glb_roundtrip(tmp_path):
    ents, pool = _small_map()
    path = str(tmp_path / "m.glb")
    save_gltf_scene(ents, pool, path, binary=True)
    assert len(os.listdir(tmp_path)) == 1  # single self-contained file
    ents2, pool2 = load_gltf_scene(path)
    _assert_scene_roundtrip(ents, pool, ents2, pool2)


def test_cornell_gltf_roundtrip(tmp_path):
    ents, pool = build_cornell_box("boxes")
    path = str(tmp_path / "cornell.gltf")
    save_gltf_scene(ents, pool, path)
    ents2, pool2 = load_gltf_scene(path)
    _assert_scene_roundtrip(ents, pool, ents2, pool2)


def test_map_scene_shape():
    ents, pool = build_map_scene()  # default e1m1-class size
    f = flatten(ents)
    tris = f.positions.shape[0] // 3
    assert 50_000 <= tris <= 120_000, tris
    flags = [int(m.flags) for m in f.materials]
    assert any(fl & MatFlag.EMISSIVE for fl in flags)
    assert any(fl & MatFlag.REFRACTIVE for fl in flags)
    # determinism
    ents_b, _ = build_map_scene()
    f_b = flatten(ents_b)
    np.testing.assert_array_equal(f.positions, f_b.positions)


def test_map_normal_map_roundtrip(tmp_path):
    ents, pool = _small_map()
    path = str(tmp_path / "m.gltf")
    save_gltf_scene(ents, pool, path)
    ents2, pool2 = load_gltf_scene(path)
    f, f2 = flatten(ents), flatten(ents2)
    pairs = [
        (m.normal_tex, m2.normal_tex)
        for m, m2 in zip(f.materials, f2.materials)
        if m.normal_tex >= 0
    ]
    assert pairs, "map should carry at least one normal-mapped material"
    for tid, tid2 in pairs:
        assert tid2 >= 0
        img, img2 = pool.get(tid), pool2.get(tid2)
        np.testing.assert_allclose(img[..., :2], img2[..., :2], atol=0.02)


@pytest.mark.slow
def test_map_renders_end_to_end(tmp_path):
    """Full pipeline: generate -> export -> import -> build_scene -> trace."""
    import jax.numpy as jnp

    from pim.core import rng
    from pim.render.camera import Camera, DofInfo, camera_arrays, generate_primary_rays
    from pim.render.integrator import trace_rays
    from pim.render.scene import build_scene

    path = export_map("tinymap", base_dir=str(tmp_path), rooms=(1, 2),
                      spheres_per_room=1, sphere_steps=8, tex_size=32)
    ents, pool = load_gltf_scene(path)
    meta, arrays, lights = build_scene(ents, pool)
    assert meta.tri_count > 500
    assert meta.emissive_count >= 2  # one panel per room

    cam = Camera()
    cam.position = np.array([0.0, 1.6, 0.0], np.float32)
    cam.look_at([0.0, 1.2, 8.0])
    w = h = 16
    state = rng.make_state(jnp.arange(w * h, dtype=jnp.uint32), jnp.uint32(0))
    ca = camera_arrays(cam, DofInfo(), w, h)
    state, ro, rd = generate_primary_rays(ca, w, h, state, 5, 0.0)
    result = trace_rays(meta, arrays, lights, ro, rd, state, max_bounces=3)
    color = np.asarray(result.color)
    assert np.isfinite(color).all()
    assert color.max() > 0.0  # emissive panels are visible
