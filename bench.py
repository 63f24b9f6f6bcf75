#!/usr/bin/env python
"""Headline benchmark: path-tracing throughput (Mrays/s) on the GPU.

Two cells (BASELINE.md rows 1 and 3/4):
  * cornell512 — Cornell box 512², 10 bounces (108 tris).
  * e1m1_512   — the ~81k-tri generated map through the full end-to-end
    frame: glTF import, textured atlas materials, BVH traversal, sky
    cubemap (skylight panels), NEE light grid, histogram autoexposure.
    Ref analog: CmdLoadMap + pt_test (render_system.c:1348-1464).

Each cell times the full progressive-frame wavefront (raygen -> RR ->
extend ray -> NEE ray -> shade -> accumulate [-> exposure]) on the
default device, counting every ray actually cast, and checks its
radiance gate (pim/render/bench_gate_bands.json).  The intersector is
build_scene's platform rule (render/platform.py).

The run refuses any device but a GPU, prints the device (platform,
device_kind, count) and the card (name, power limit), and exits nonzero
if either cell fails or leaves its band.  The last line is one JSON
object with both cells.

The `vs_baseline` denominator is a documented estimate of the reference's
CPU/Embree class on the Cornell scene: ~30 Mrays/s on a modern 16-thread
AVX2 desktop (the reference publishes no numbers, BASELINE.md).

Usage: python bench.py
"""

from __future__ import annotations

import json
import os
import sys
import time

BASELINE_MRAYS = 30.0
WIDTH = HEIGHT = 512
MAX_BOUNCES = 10
WARMUP = 3
ITERS = 10
# Cornell samples per dispatched step: a progressive multi-spp frame whose
# radiance is the mean of independent 1-spp traces with distinct sample
# indices.  Kept at 16 until the device's idle share at 1 spp is measured.
# The e1m1 cell dispatches one sample (plus exposure) per step.
SPP_PER_STEP = 16


def _measure(step, arrays, lights, ca, iters=ITERS, warmup=WARMUP):
    """Returns (Mrays/s, s/step, image mean).  All steps are dispatched
    before one sync, so no host round trip sits inside the window."""
    import jax
    import jax.numpy as jnp

    for i in range(warmup):
        mean, rays = step(arrays, lights, ca, jnp.uint32(i))
    mean.block_until_ready()

    ray_handles = []
    mean_handles = []
    t0 = time.perf_counter()
    for i in range(iters):
        mean, rays = step(arrays, lights, ca, jnp.uint32(warmup + i))
        ray_handles.append(rays)
        mean_handles.append(mean)
    jax.block_until_ready((ray_handles, mean_handles))
    elapsed = time.perf_counter() - t0
    total_rays = sum(float(r) for r in ray_handles)
    img_mean = sum(float(m) for m in mean_handles) / iters
    return total_rays / elapsed / 1e6, elapsed / iters, img_mean


def check_gate(tag, img_mean) -> bool:
    """Radiance gate: the accumulated image mean must sit inside the
    calibrated band (tools/calibrate_bench_gate.py), so a published
    Mrays/s can never come from a silently broken render (ref analog
    CmdPtTest, render_system.c:1348-1410).  Both bands are CPU-framework
    anchors."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "pim", "render", "bench_gate_bands.json")
    with open(path) as f:
        band = json.load(f)[tag]
    lo = band["mean"] - band["half"]
    hi = band["mean"] + band["half"]
    ok = lo <= img_mean <= hi
    print(f"# gate[{tag}] mean={img_mean:.5f} band=[{lo:.5f}, {hi:.5f}] "
          f"({band['kind']}): {'ok' if ok else 'FAIL'}", file=sys.stderr)
    return ok


def cornell_scene(backend="auto"):
    import numpy as np

    from pim.geom.cornell import build_cornell_box
    from pim.render.camera import Camera
    from pim.render.scene import build_scene

    ents, pool = build_cornell_box("boxes")
    scene = build_scene(ents, pool, backend=backend)
    cam = Camera(position=np.array([-4, 0, 4], np.float32))
    cam.look_at([0, -1, 0])
    return scene, cam


def e1m1_scene(backend="auto"):
    """The generated map with its sky; regenerates the asset if data/e1m1
    is absent."""
    import numpy as np

    from pim.geom.gltf import load_gltf_scene
    from pim.render.camera import Camera
    from pim.render.scene import build_scene
    from pim.render.sky import bake_sky_cubemap, earth_atmosphere

    path = os.path.join("data", "e1m1", "glTF", "e1m1.gltf")
    if not os.path.exists(path):
        from pim.geom.maps import export_map

        path = export_map("e1m1", base_dir="data", rooms=(3, 3), seed=1)
    ents, pool = load_gltf_scene(path)
    sun_dir = np.array([0.35, 0.82, 0.45], np.float32)
    sun_dir /= np.linalg.norm(sun_dir)
    sky = np.asarray(bake_sky_cubemap(earth_atmosphere(), sun_dir, 3800.0, 32, 8))
    scene = build_scene(ents, pool, backend=backend, sky=sky)
    # inside the (0,0) room, under a skylight, looking across the map
    cam = Camera(position=np.array([-2.5, 1.7, -2.5], np.float32))
    cam.look_at([6.0, 1.0, 6.0])
    return scene, cam


def make_step(meta, spp: int, exposure: bool):
    """The jitted bench step: `spp` 1-spp traces -> (image mean, rays
    cast).  With `exposure`, the histogram autoexposure pass runs on the
    accumulated image inside the same launch."""
    import jax
    import jax.numpy as jnp

    from pim.core import rng
    from pim.render.camera import generate_primary_rays
    from pim.render.exposure import (
        ExposureParams, exposure_pass, make_exposure_state,
    )
    from pim.render.integrator import trace_rays

    n = WIDTH * HEIGHT
    exp_params = ExposureParams.from_cvars()

    @jax.jit
    def step(arrays, lights, cam, sample_idx):
        def one(i, carry):
            acc, rays = carry
            state = rng.make_state(
                jnp.arange(n, dtype=jnp.uint32),
                sample_idx * spp + i)
            state, ro, rd = generate_primary_rays(cam, WIDTH, HEIGHT, state)
            res = trace_rays(meta, arrays, lights, ro, rd, state, MAX_BOUNCES)
            return acc + res.color, rays + res.rays_traced

        acc, rays = jax.lax.fori_loop(
            0, spp, one, (jnp.zeros((n, 3), jnp.float32), jnp.float32(0.0)))
        img = acc * (1.0 / spp)
        if exposure:
            exp = exposure_pass(img, exp_params, make_exposure_state(),
                                jnp.float32(1 / 60))
            rays = rays + 0.0 * exp.exposure
        return jnp.mean(img), rays

    return step


CELLS = {  # tag -> (scene builder, samples per step, exposure pass)
    "cornell512": (cornell_scene, SPP_PER_STEP, False),
    "e1m1_512": (e1m1_scene, 1, True),
}


def run_cell(tag):
    from pim.render.camera import DofInfo, camera_arrays

    scene_fn, spp, exposure = CELLS[tag]
    (meta, arrays, lights), cam = scene_fn()
    ca = camera_arrays(cam, DofInfo(autofocus=False), WIDTH, HEIGHT)
    mrays, step_s, img_mean = _measure(make_step(meta, spp, exposure),
                                       arrays, lights, ca)
    return {"mrays_per_s": mrays, "step_ms": step_s * 1e3,
            "tris": int(meta.tri_count), "backend": meta.backend,
            "image_mean": img_mean, "gate_ok": check_gate(tag, img_mean)}


def main() -> None:
    from pim.core.compile_cache import enable_compile_cache
    from pim.core.device import card, require_gpu

    dev = require_gpu()
    print(f"# device: {dev['platform']} {dev['kind']} x{dev['count']}")
    card_line = card()
    print(f"# card: {card_line}")
    enable_compile_cache()
    cells = {tag: run_cell(tag) for tag in CELLS}
    cornell = cells["cornell512"]["mrays_per_s"]
    print(json.dumps({
        "metric": "cornell512_pathtrace_throughput",
        "value": cornell,
        "unit": "Mrays/s",
        "vs_baseline": cornell / BASELINE_MRAYS,
        "cells": cells,
        "device": dev,
        "card": card_line,
    }))
    if not all(c["gate_ok"] for c in cells.values()):
        raise SystemExit(1)  # a broken render must not publish a number


if __name__ == "__main__":
    main()
