import jax.numpy as jnp
import numpy as np
import pytest

from pim.core.crate import Crate
from pim.geom.cornell import build_cornell_box
from pim.geom.entities import flatten
from pim.render import lightmap as lm
from pim.render.scene import build_scene


@pytest.fixture(scope="module")
def cornell():
    ents, pool = build_cornell_box("boxes")
    meta, arrays, lights = build_scene(ents, pool, backend="brute")
    flat = flatten(ents)
    return meta, arrays, lights, flat


def test_pack_embeds_texels(cornell):
    meta, arrays, lights, flat = cornell
    pack = lm.pack_lightmaps(flat.positions, flat.normals,
                             texels_per_meter=1.0, atlas_size=128)
    assert pack is not None
    counts = np.asarray(pack.sample_counts)
    live = counts > 0
    assert live.sum() > 500  # walls are 10x10m at 1 texel/m, several charts
    # embedded positions lie within the scene bounds
    pos = np.asarray(pack.position).T[live]
    assert (np.abs(pos) < 5.2).all()
    # normals are unit
    nrm = np.asarray(pack.normal).T[live]
    np.testing.assert_allclose(np.linalg.norm(nrm, axis=-1), 1.0, atol=1e-4)


@pytest.mark.slow
def test_progressive_bake_accumulates(cornell):
    meta, arrays, lights, flat = cornell
    pack = lm.pack_lightmaps(flat.positions, flat.normals,
                             texels_per_meter=0.5, atlas_size=32)
    live0 = np.asarray(pack.sample_counts)
    for frame in range(4):
        pack = lm.bake_step(meta, arrays, lights, pack, frame, max_bounces=2)
    counts = np.asarray(pack.sample_counts)
    live = live0 > 0
    np.testing.assert_array_equal(counts[live], live0[live] + 4)
    np.testing.assert_array_equal(counts[~live], 0.0)
    probes = np.asarray(pack.probes)
    assert np.isfinite(probes).all()
    # lit scene: some probes accumulated positive radiance
    assert probes[live][..., :3].max() > 1e-4
    # irradiance eval works
    irr = np.asarray(
        lm.lightmap_irradiance(pack, np.asarray(pack.normal).T)
    )
    assert np.isfinite(irr).all()
    assert irr[live].max() > 0.0


def test_sharded_bake_bit_identical(cornell):
    """Process-sharded bake (contiguous texel slices, the scaling
    harness's lmbake mode / ref task-pool range claiming) is BIT-IDENTICAL
    to the unsharded bake: per-texel rng is (texel_id, frame)-seeded, so
    slice boundaries cannot change any texel's samples."""
    meta, arrays, lights, flat = cornell
    pack0 = lm.pack_lightmaps(flat.positions, flat.normals,
                              texels_per_meter=0.5, atlas_size=32)
    t = pack0.position.shape[1]
    half = t // 2

    full = pack0
    for frame in range(2):
        full = lm.bake_step(meta, arrays, lights, full, frame, max_bounces=2)

    shard = pack0
    for frame in range(2):
        shard = lm.bake_step(meta, arrays, lights, shard, frame,
                             max_bounces=2, texel_offset=0, texel_count=half)
        shard = lm.bake_step(meta, arrays, lights, shard, frame,
                             max_bounces=2, texel_offset=half,
                             texel_count=t - half)

    np.testing.assert_array_equal(np.asarray(full.probes),
                                  np.asarray(shard.probes))
    np.testing.assert_array_equal(np.asarray(full.sample_counts),
                                  np.asarray(shard.sample_counts))


def test_lmpack_crate_roundtrip(cornell, tmp_path):
    meta, arrays, lights, flat = cornell
    pack = lm.pack_lightmaps(flat.positions, flat.normals,
                             texels_per_meter=0.5, atlas_size=32)
    pack = lm.bake_step(meta, arrays, lights, pack, 0, max_bounces=2)
    crate = Crate()
    crate.set("lmpack", lm.lmpack_to_crate_entry(pack))
    path = str(tmp_path / "lm.crate")
    crate.save(path)
    pack2 = lm.lmpack_from_crate_entry(Crate.load(path).get("lmpack"))
    np.testing.assert_array_equal(
        np.asarray(pack.sample_counts), np.asarray(pack2.sample_counts)
    )
    np.testing.assert_array_equal(np.asarray(pack.probes), np.asarray(pack2.probes))
    # resume: baking continues from the restored counts
    pack3 = lm.bake_step(meta, arrays, lights, pack2, 1, max_bounces=2)
    live = np.asarray(pack.sample_counts) > 0
    np.testing.assert_array_equal(
        np.asarray(pack3.sample_counts)[live],
        np.asarray(pack2.sample_counts)[live] + 1,
    )
