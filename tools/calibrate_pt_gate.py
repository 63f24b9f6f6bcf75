"""Calibrate the pt_gate convergence bands.

Runs a gated scene config for N independent seeds at each resolution,
snapshotting the luminance stddev and buffer mean at every sample-count
tier.  The band per tier is pooled over all (seed, resolution) runs:

  maxstddev = max(sd)  * (1 + rel) + 6*sigma(sd)
  meanlo    = min(mean)* (1 - rel) - 6*sigma(mean)
  meanhi    = max(mean)* (1 + rel) + 6*sigma(mean)

with rel = 2% — wide enough for device/fp-reassociation drift, ~10x
tighter than the hand-waved r3 band (which tolerated a ±25% mean shift).

Scenes (ref CmdPtTest + CmdLoadMap, render_system.c:1348-1464):
  cornell — the pt_test config (cornell_box boxes; teleport -4 0 4;
            lookat 0 -1 0; exp_manual 1; exp_evoffset 5)
  e1m1    — the generated map through the full import path (textured
            atlas + sky; camera as bench.py)

Bands are keyed by aspect (width / height): a 16:9 frame of the map sees
more wall and less sky than a square one, so its mean differs by ~40%.
Calibrate on the CPU framework (JAX_PLATFORMS=cpu), where the map takes
the XLA BVH path; the GPU's traversal kernel must land in the same band.

Merges into pim/render/pt_gate_bands.json (committed; loaded by
pt_gate, keyed per scene) — other scenes' entries are preserved.

Usage: JAX_PLATFORMS=cpu python tools/calibrate_pt_gate.py [--scene cornell]
       [--seeds 5] [--res 128,256,128x72] [--tiers 8,16,64,256]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pim.core.compile_cache import enable_compile_cache
enable_compile_cache()

REL = 0.02
BANDS_PATH = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..",
    "pim", "render", "pt_gate_bands.json"))


def _setup_scene(rs, scene: str):
    import numpy as np

    if scene == "cornell":
        from pim.geom.cornell import build_cornell_box

        rs.entities, rs.pool = build_cornell_box("boxes")
        rs.camera.reset()
        rs.camera.position = np.asarray([-4, 0, 4], np.float32)
        rs.camera.look_at([0, -1, 0])
        return
    if scene == "e1m1":
        from pim.core import cvars as cv
        from pim.geom.gltf import load_gltf_scene
        from pim.render.sky import bake_sky_cubemap, earth_atmosphere

        path = os.path.join("data", "e1m1", "glTF", "e1m1.gltf")
        if not os.path.exists(path):
            from pim.geom.maps import export_map

            path = export_map("e1m1", base_dir="data", rooms=(3, 3), seed=1)
        rs.entities, rs.pool = load_gltf_scene(path)
        rs.camera.reset()
        rs.camera.position = np.asarray([-2.5, 1.7, -2.5], np.float32)
        rs.camera.look_at([6.0, 1.0, 6.0])
        # the sky bake rides _bake_sky (sun cvars at defaults)
        return
    raise SystemExit(f"unknown scene '{scene}'")


def run_seeds(scene, width, height, seeds, tiers):
    """All seeded runs at one resolution, reusing the compiled frame step
    (cv_pt_seed is a traced input — no recompile)."""
    import numpy as np

    from pim.core import cvars as cv
    from pim.render.render_system import RenderSystem

    cv.cv_pt_trace.set(True)
    cv.cv_exp_manual.set(True)
    cv.cv_exp_evoffset.set(5.0)
    cv.cv_pt_denoise.set(False)
    # bands are calibrated per-sample: pin spp=1 so a saved config with
    # pt_spp>1 cannot skew the sample_count<->frame bookkeeping (advisor
    # r4; batched samples share the batch-start light pdf, so bands for
    # batched runs must be calibrated separately at that pt_spp)
    cv.cv_pt_spp.set(1)

    rs = RenderSystem(width=width, height=height)
    _setup_scene(rs, scene)

    results = []
    top = max(tiers)
    for seed in seeds:
        cv.cv_pt_seed.set(int(seed))
        out = {}
        # first update() notices the dirty seed and resets accumulation
        for frame in range(1, top + 1):
            rs.update()
            assert rs.sample_count == frame, (rs.sample_count, frame)
            if frame in tiers:
                out[frame] = (rs.stddev(),
                              float(np.asarray(rs.buffers.color).mean()))
        results.append((seed, out))
    return results, rs.meta.backend


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cornell")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--res", default="128,256",
                    help="comma list of N (square) or WxH")
    ap.add_argument("--tiers", default="8,16,64,256")
    args = ap.parse_args()

    import jax

    resolutions = [tuple(int(v) for v in r.split("x")) if "x" in r
                   else (int(r), int(r)) for r in args.res.split(",")]
    tiers = sorted(int(t) for t in args.tiers.split(","))
    seeds = [0x9E3779B9] + [1000003 * (i + 1) for i in range(args.seeds - 1)]

    runs = {t: [] for t in tiers}
    backend = None
    for w, h in resolutions:
        results, backend = run_seeds(args.scene, w, h, seeds, set(tiers))
        for seed, snap in results:
            for t, (sd, mean) in snap.items():
                runs[t].append({"res": f"{w}x{h}", "aspect": round(w / h, 4),
                                "seed": seed, "stddev": sd, "mean": mean})
                print(f"res={w}x{h} seed={seed:#x} n={t}: "
                      f"stddev={sd:.4f} mean={mean:.4f}", flush=True)

    import numpy as np

    entries = []
    for aspect in sorted({round(w / h, 4) for w, h in resolutions}):
        for t in tiers:
            sel = [r for r in runs[t] if r["aspect"] == aspect]
            sds = np.array([r["stddev"] for r in sel])
            means = np.array([r["mean"] for r in sel])
            entries.append({
                "scene": args.scene,
                "aspect": aspect,
                "min_samples": t,
                "maxstddev": float(sds.max() * (1 + REL) + 6 * sds.std()),
                "meanlo": float(means.min() * (1 - REL) - 6 * means.std()),
                "meanhi": float(means.max() * (1 + REL) + 6 * means.std()),
            })

    data = {"entries": [], "calibrations": {}}
    if os.path.exists(BANDS_PATH):
        with open(BANDS_PATH) as f:
            data = json.load(f)
        data.setdefault("calibrations", {})
        # migrate pre-scene-key files
        for e in data.get("entries", []):
            e.setdefault("scene", "cornell")
    aspects = {e["aspect"] for e in entries}
    data["entries"] = [e for e in data.get("entries", [])
                       if e.get("scene") != args.scene
                       or e.get("aspect") not in aspects] + entries
    cal = data["calibrations"].setdefault(args.scene, {})
    for aspect in sorted(aspects):
        cal[str(aspect)] = {
            "platform": jax.default_backend(),
            "backend": backend,
            "resolutions": [f"{w}x{h}" for w, h in resolutions
                            if round(w / h, 4) == aspect],
            "seeds": [hex(s) for s in seeds],
            "rel_margin": REL,
            "runs": {str(t): [r for r in runs[t] if r["aspect"] == aspect]
                     for t in tiers},
        }
    data.pop("runs", None)
    data.pop("scene", None)
    data.pop("device", None)
    data.pop("resolutions", None)
    data.pop("seeds", None)
    data.pop("rel_margin", None)
    with open(BANDS_PATH, "w") as f:
        json.dump(data, f, indent=1)
    print(f"wrote {BANDS_PATH}")
    for e in entries:
        print(e)


if __name__ == "__main__":
    main()
