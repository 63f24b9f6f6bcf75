"""Calibrate bench.py's radiance gates on the CPU framework.

Both bands are ABSOLUTE anchors from the CPU render of bench.py's own
scene and camera (pim/render/bench_gate_bands.json):

  cornell512: the brute-force intersector at the bench's config (512 x
    512, 10 bounces), itself certified against the numpy reference oracle
    by tests/test_parity.py; band = cpu_mean +- max(1%, 4 sigma).
  e1m1_512: the XLA BVH loop (the CPU path for 81k tris) at the largest
    square resolution a CPU run affords (the `kind` says which); the
    image mean of a square view moves by well under 1% between 64² and
    512²; band = cpu_mean +- max(1.5%, 6 sigma).

bench.py then requires the GPU's accumulated image mean to sit inside the
band: a published Mrays/s cannot come from a silently broken render.

Usage:
  JAX_PLATFORMS=cpu python tools/calibrate_bench_gate.py cornell
  JAX_PLATFORMS=cpu python tools/calibrate_bench_gate.py e1m1 [RES]

Ref analog: CmdPtTest's scripted gate, render_system.c:1348-1410.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BANDS_PATH = os.path.join(ROOT, "pim", "render", "bench_gate_bands.json")


def _render_means(scene_fn, res, seeds, spp):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from pim.core import rng
    from pim.render.camera import DofInfo, camera_arrays, generate_primary_rays
    from pim.render.integrator import trace_rays

    (meta, arrays, lights), cam = scene_fn()
    ca = camera_arrays(cam, DofInfo(autofocus=False), res, res)
    n = res * res

    @jax.jit
    def step(sample_idx):
        state = rng.make_state(jnp.arange(n, dtype=jnp.uint32), sample_idx)
        state, ro, rd = generate_primary_rays(ca, res, res, state)
        return trace_rays(meta, arrays, lights, ro, rd, state,
                          bench.MAX_BOUNCES).color

    means = []
    for seed in seeds:
        acc = None
        t0 = time.perf_counter()
        for s in range(spp):
            c = step(jnp.uint32(seed * 4096 + s))
            acc = c if acc is None else acc + c
        m = float(jnp.mean(acc)) / spp
        means.append(m)
        print(f"seed {seed}: mean {m:.6f}  ({time.perf_counter() - t0:.0f}s)")
    return meta, np.asarray(means)


def main():
    import jax
    import numpy as np

    import bench

    if jax.default_backend() != "cpu":
        raise SystemExit("calibrate on the CPU framework (JAX_PLATFORMS=cpu)")
    which = sys.argv[1] if len(sys.argv) > 1 else "cornell"
    with open(BANDS_PATH) as f:
        bands = json.load(f)
    if which == "cornell":
        seeds, spp = (1, 2, 3, 4, 5, 6), 32
        meta, means = _render_means(bench.cornell_scene, bench.WIDTH, seeds,
                                    spp)
        center = float(means.mean())
        sigma = float(means.std(ddof=1) / np.sqrt(len(means)))
        bands["cornell512"] = {
            "kind": "absolute(cpu-framework anchor)",
            "backend": meta.backend, "mean": center,
            "half": max(0.01 * center, 4.0 * sigma), "seed_sigma": sigma,
            "seeds": len(seeds), "spp": spp,
        }
    elif which == "e1m1":
        res = int(sys.argv[2]) if len(sys.argv) > 2 else bench.WIDTH
        seeds, spp = (1, 2, 3), 16
        meta, means = _render_means(bench.e1m1_scene, res, seeds, spp)
        center = float(means.mean())
        sigma = float(means.std(ddof=1) / np.sqrt(len(means)))
        bands["e1m1_512"] = {
            "kind": f"absolute(cpu-framework anchor, rendered at {res}x{res})",
            "backend": meta.backend, "mean": center,
            "half": max(0.015 * center, 6.0 * sigma), "seed_sigma": sigma,
            "seeds": len(seeds), "spp": spp,
        }
    else:
        raise SystemExit(f"unknown config {which}")
    with open(BANDS_PATH, "w") as f:
        json.dump(bands, f, indent=1, sort_keys=True)
    print("wrote", BANDS_PATH, json.dumps(bands))


if __name__ == "__main__":
    main()
