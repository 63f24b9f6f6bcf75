"""Full-map e1m1 progressive lightmap bake, end to end (BASELINE config
#5).

Packs e1m1's ~81k tris at the reference release density (4 texels/m,
the reference's src/common/cvars.c:499-525), runs the progressive SG bake
to a fixed sample budget on the GPU (texel-sharded steps so the wavefront
stays 256k lanes), exercises the crate save -> load -> continue resume
path with a bit-identity check mid-run, denoises the irradiance atlas
(DenoiseType.Lightmap), and writes artifacts:

  data/e1m1/lmpack.npz                  the resumable crate checkpoint (gitignored)
  screenshots/e1m1_lightmap_preview.png the denoised irradiance atlas
  prints: texel count, atlas size, texels/s, step ms

Ref: LmPack_Pack/Bake lightmap.c:1047-1201, Lightmap_Trace
render_system.c:181-213.

Usage: python tools/bake_e1m1_lightmap.py [spp] [density]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
from pim.core.compile_cache import enable_compile_cache
enable_compile_cache()

import jax.numpy as jnp
import numpy as np


def main():
    spp = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    density = float(sys.argv[2]) if len(sys.argv) > 2 else 4.0

    from pim.core.crate import Crate
    from pim.geom.entities import flatten
    from pim.geom.gltf import load_gltf_scene
    from pim.render import lightmap as lm
    from pim.render.denoise import DenoiseType, denoise
    from pim.render.scene import build_scene
    from pim.render.screenshot import write_png
    from pim.render.sky import bake_sky_cubemap, earth_atmosphere

    path = os.path.join("data", "e1m1", "glTF", "e1m1.gltf")
    if not os.path.exists(path):
        from pim.geom.maps import export_map

        path = export_map("e1m1", base_dir="data", rooms=(3, 3), seed=1)
    ents, pool = load_gltf_scene(path)
    sun_dir = np.array([0.35, 0.82, 0.45], np.float32)
    sun_dir /= np.linalg.norm(sun_dir)
    sky = np.asarray(bake_sky_cubemap(earth_atmosphere(), sun_dir, 3800.0, 32, 8))
    meta, arrays, lights = build_scene(ents, pool, backend="auto", sky=sky)
    flat = flatten(ents)

    t0 = time.perf_counter()
    pack = lm.pack_lightmaps(flat.positions, flat.normals,
                             texels_per_meter=density)
    t_total = int(pack.position.shape[1])
    live = int(np.asarray(pack.sample_counts > 0).sum())
    print(f"pack: atlas {pack.size}^2, {t_total} texels ({live} live) "
          f"at {density} texels/m in {time.perf_counter()-t0:.1f}s")

    # live-texel compaction: the shelf-packed atlas is ~8% occupied, so
    # baking the raw texel range wastes 12x wavefront on dead lanes.  The
    # bake runs over a dense live-texel view (host-side gather once) and
    # scatters back into atlas order for the crate/preview.  RNG keys ride
    # the ORIGINAL texel ids, so compacted and raw bakes are bit-identical.
    counts0 = np.asarray(pack.sample_counts)
    live_idx = np.nonzero(counts0 > 0)[0]
    n_live = len(live_idx)
    chunk = min(1 << 18, max(1 << 12, 1 << int(np.ceil(np.log2(len(live_idx))))))
    live_pad = -(-len(live_idx) // chunk) * chunk
    lidx = np.pad(live_idx, (0, live_pad - len(live_idx)))  # pad repeats texel 0
    pad_dead = np.zeros(live_pad, np.float32)
    pad_dead[: len(live_idx)] = 1.0

    def compact(p):
        return p._replace(
            position=p.position[:, lidx],
            normal=p.normal[:, lidx],
            probes=p.probes[lidx],
            sample_counts=p.sample_counts[lidx] * pad_dead,  # pad lanes dead
        )

    def scatter_back(full, dense):
        n_live = len(live_idx)
        return full._replace(
            probes=full.probes.at[live_idx].set(dense.probes[:n_live]),
            sample_counts=full.sample_counts.at[live_idx].set(
                dense.sample_counts[:n_live]),
        )

    nchunks = live_pad // chunk
    bounces = 4
    # NOTE: bake_step keys its RNG by (texel index within the pack, frame);
    # the dense view's indices differ from atlas indices, which is fine —
    # streams stay decorrelated and the resume check below still certifies
    # bit-identity of the save/load path on the SAME view.

    import functools

    bake_chunks = [
        jax.jit(functools.partial(
            lm.bake_step, meta, max_bounces=bounces,
            texel_offset=ci * chunk, texel_count=chunk))
        for ci in range(nchunks)
    ]

    def bake_frame(p, frame):
        for fn in bake_chunks:
            p = fn(arrays, lights, p, jnp.uint32(frame))
        return p

    # warmup/compile
    dense = compact(pack)
    dense = bake_frame(dense, 0)
    jax.block_until_ready(dense.probes)
    t0 = time.perf_counter()
    dense = bake_frame(dense, 1)
    jax.block_until_ready(dense.probes)
    step_s = time.perf_counter() - t0
    print(f"bake step: {step_s*1e3:.0f} ms for {n_live} live texels "
          f"({n_live/step_s/1e6:.2f} Mtexel-samples/s)")

    # mid-run crate resume check: save -> load -> continue must be
    # bit-identical to continuing in memory (the ref's DiskLmPack resume,
    # lightmap.c:1225+, sample counts preserved)
    crate_path = os.path.join("data", "e1m1", "lmpack.npz")
    crate = Crate()
    p = scatter_back(pack, dense)
    crate.set("e1m1_lmpack", lm.lmpack_to_crate_entry(p))
    crate.save(crate_path)
    p_loaded = lm.lmpack_from_crate_entry(
        Crate.load(crate_path).get("e1m1_lmpack"))
    a = bake_frame(dense, 2)
    b = bake_frame(compact(p_loaded), 2)
    assert np.array_equal(np.asarray(a.probes)[:n_live],
                          np.asarray(b.probes)[:n_live]), \
        "crate resume is not bit-identical"
    print("crate resume: bit-identical after save/load/continue")
    dense = a

    frames_done = 3
    t0 = time.perf_counter()
    for f in range(frames_done, spp):
        dense = bake_frame(dense, f)
    jax.block_until_ready(dense.probes)
    el = time.perf_counter() - t0
    done = spp - frames_done
    print(f"baked {spp} spp total: {done} frames in {el:.1f}s "
          f"({done*n_live/el/1e6:.2f} Mtexel-samples/s over live texels)")

    p = scatter_back(pack, dense)
    crate.set("e1m1_lmpack", lm.lmpack_to_crate_entry(p))
    crate.save(crate_path)
    print(f"saved {crate_path}")

    # denoised irradiance preview (DenoiseType.Lightmap end-to-end)
    irr = lm.lightmap_irradiance(p, np.asarray(
        jnp.stack([p.normal[0], p.normal[1], p.normal[2]], axis=-1)))
    irr = np.asarray(irr).reshape(p.size, p.size, 3)
    alb = np.ones_like(irr)
    nrm = np.asarray(p.normal).T.reshape(p.size, p.size, 3)
    den = np.asarray(denoise(DenoiseType.Lightmap, p.size, p.size,
                             jnp.asarray(irr), jnp.asarray(alb),
                             jnp.asarray(nrm)))
    img = den / (1.0 + den)  # Reinhard for preview
    # crop to the occupied shelf rows (the pow2 atlas is sparsely packed)
    occ = np.asarray(p.sample_counts).reshape(p.size, p.size) > 0
    rows = np.nonzero(occ.any(axis=1))[0]
    y1 = int(rows.max()) + 1 if rows.size else p.size
    img = img[:y1]
    rgb8 = np.clip(np.power(np.clip(img, 0, 1), 1 / 2.2) * 255 + 0.5,
                   0, 255).astype(np.uint8)
    out = os.path.join("screenshots", "e1m1_lightmap_preview.png")
    write_png(out, rgb8)
    print(f"wrote {out} ({rgb8.shape[1]}x{rgb8.shape[0]})")


if __name__ == "__main__":
    main()
