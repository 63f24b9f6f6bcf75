#!/usr/bin/env python
"""Proof that the path tracer runs on the GPU, through its user entry points.

  python chip_smoke.py          one card, five phases:
    1. device    JAX's device and the card (nvidia-smi name, power limit);
                 anything but a GPU stops the run
    2. kernels   the traversal kernel compiled for the card against the XLA
                 references at real widths: e1m1 1920x1080 primary rays plus
                 one bounce of secondary and NEE shadow rays, Cornell 512²;
                 fetch_cols bit-exact against a plain gather; then the
                 `gpu`-marked tests in this process
    3. e1m1      Engine(1920, 1080) runs `exec scripts/pt_test_e1m1.cmd`
                 exactly as `python -m pim.app` does, e1m1 pt_gate included
    4. cornell   Engine(512, 512) runs `pt_test -frames 64` with its pt_gate
    5. train     one make_train_step on Cornell: finite loss, albedo moves
  python chip_smoke.py --four   four cards: the sharded e1m1 1920x1080
                 render and the sharded train step, each against the same
                 work on one card; no other phase

Each phase prints one result line; a failed check raises, so the exit code
is nonzero and the closing JSON line is never printed.  Everything runs in
this one process (a second JAX process could not get the card's memory).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from pim.core.device import card, describe  # noqa: E402

E1M1_W, E1M1_H = 1920, 1080
CORNELL_RES = 512
TRI_AGREE = 0.999      # closest-hit: share of live lanes with the same tri
T_REL = 1e-5           # ... and t agreement where the tri differs (ties)
ANY_AGREE = 0.9999     # any-hit: share of lanes with the same flag


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAIL: {what}")


def phase_device(count: int) -> dict:
    dev = describe()
    print(f"[device] platform={dev['platform']} kind={dev['kind']} "
          f"count={dev['count']}", flush=True)
    check(dev["platform"] == "gpu", f"JAX's device is {dev['platform']!r}, "
          "not a GPU")
    check(dev["count"] >= count, f"{count} cards needed, {dev['count']} found")
    print(f"[card] {card()}", flush=True)
    return dev


# --- phase 2: kernel parity --------------------------------------------------


def wavefront_rays(meta, arrays, lights, ca, width, height):
    """The rays of a real frame: primary, plus one bounce of BSDF
    continuation rays and NEE shadow rays from the primary hits (traced
    with the XLA reference, so both sides see the same rays)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from pim.core import rng
    from pim.math.brdf import BrdfLut
    from pim.math.vec3 import EPS, RCP_EPS
    from pim.render.bsdf import scatter_principled
    from pim.render.camera import generate_primary_rays
    from pim.render.lights import make_light_table, sample_light
    from pim.render.scene import scene_intersect
    from pim.render.surface import fetch_hit_attribs, get_surface

    ref_meta = dataclasses.replace(meta, backend="bvh")
    n = width * height

    @jax.jit
    def rays(arrays, lights, ca):
        state = rng.make_state(jnp.arange(n, dtype=jnp.uint32), 0)
        state, ro, rd = generate_primary_rays(ca, width, height, state)
        hit = scene_intersect(ref_meta, arrays, ro, rd, 0.0, RCP_EPS)
        surf = get_surface(ref_meta, arrays, ro, rd, hit,
                           attribs=fetch_hit_attribs(ref_meta, arrays, hit))
        alive = hit.tri >= 0
        state, scat = scatter_principled(BrdfLut(texels=arrays.brdf_lut),
                                         surf, rd, state)
        cont = alive & (scat.pdf > EPS)
        table = make_light_table(lights, arrays.cell_active_f)
        state, u_sel = rng.next_f32(state)
        state, (bu, bv) = rng.next_f32x2(state)
        ls = sample_light(meta, arrays, table, surf.p, u_sel, bu, bv)
        shadow_far = jnp.where(alive & ls.ok, ls.dist * (1.0 - 1e-3), 0.0)
        full = jnp.full((n,), RCP_EPS, jnp.float32)
        return [(ro, rd, full),
                (scat.pos, scat.dir, jnp.where(cont, RCP_EPS, 0.0)),
                (surf.p, ls.dir, shadow_far)]

    return [(name, *r) for name, r in
            zip(("primary", "secondary", "shadow"), rays(arrays, lights, ca))]


def compare(meta, arrays, sets, label: str) -> None:
    import jax
    import numpy as np

    from pim.render import bvh_kernel
    from pim.render import intersect as isect
    from pim.render.scene import _bvh

    bvh = _bvh(arrays)

    def kernel(ro, rd, t_far, any_hit):
        return bvh_kernel.traverse(bvh, arrays.positions, ro, rd, 0.0, t_far,
                                   stack=meta.bvh_depth,
                                   max_leaf=meta.max_leaf, any_hit=any_hit)

    def reference(ro, rd, t_far, any_hit):
        t, tri, _, _, _ = isect._traverse(
            *bvh, arrays.positions, ro.aos(), rd.aos(), 0.0, t_far,
            max_leaf=meta.max_leaf, any_hit=any_hit)
        return t, tri

    def timed(fn, *args):
        """(result, ms of a second, warm call)."""
        jax.block_until_ready(fn(*args))
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        return out, (time.perf_counter() - t0) * 1e3

    for name, ro, rd, t_far in sets:
        live = np.asarray(t_far) > 0
        for any_hit in (False, True):
            (tk, trik), ms_k = timed(kernel, ro, rd, t_far, any_hit)
            (tr, trir), ms_r = timed(reference, ro, rd, t_far, any_hit)
            tk, trik, tr, trir = map(np.asarray, (tk, trik, tr, trir))
            times = f"kernel {ms_k:.2f} ms, XLA loop {ms_r:.2f} ms"
            if any_hit:
                agree = float(np.mean((trik >= 0) == (trir >= 0)))
                print(f"[kernels] {label} {name} any-hit: flags agree on "
                      f"{agree:.6f} of {trik.size} lanes "
                      f"(blocked {np.mean(trir >= 0):.4f}; {times})",
                      flush=True)
                check(agree >= ANY_AGREE, f"{label} {name} any-hit flags")
                continue
            same = trik == trir
            share = float(np.mean(same[live])) if live.any() else 1.0
            diff = live & ~same
            both = diff & (trik >= 0) & (trir >= 0)
            rel = np.abs(tk - tr) / np.maximum(np.abs(tr), 1e-30)
            t_ok = bool(np.all(both == diff) and np.all(rel[both] <= T_REL))
            print(f"[kernels] {label} {name} closest-hit: tri agrees on "
                  f"{share:.6f} of {int(live.sum())} live lanes; "
                  f"{int(diff.sum())} differ, t within {T_REL:g} rel on "
                  f"{int(np.sum(rel[both] <= T_REL))} of them "
                  f"(hits {np.mean(trir[live] >= 0):.4f}; {times})",
                  flush=True)
            check(share >= TRI_AGREE and t_ok, f"{label} {name} closest-hit")


def fetch_exact(arrays, label: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pim.render.fetch import fetch_cols

    table = arrays.tri_table
    t = table.shape[1]
    idx = jax.random.randint(jax.random.PRNGKey(0), (1 << 20,), 0, t,
                             dtype=jnp.int32)
    got = np.asarray(jax.jit(fetch_cols)(table, idx))
    want = np.asarray(table)[:, np.asarray(idx)]
    exact = got.view(np.uint32) == want.view(np.uint32)
    print(f"[kernels] {label} fetch_cols [48, {t}] x 2^20 lanes: "
          f"bit-exact {bool(exact.all())}", flush=True)
    check(bool(exact.all()), f"{label} fetch_cols bit-exact")


def phase_kernels() -> None:
    import pytest

    from bench import cornell_scene, e1m1_scene
    from pim.render.camera import DofInfo, camera_arrays

    for label, scene_fn, w, h in (
            ("e1m1", e1m1_scene, E1M1_W, E1M1_H),
            ("cornell", cornell_scene, CORNELL_RES, CORNELL_RES)):
        (meta, arrays, lights), cam = scene_fn()
        check(meta.backend == "kernel", f"{label} backend {meta.backend}")
        ca = camera_arrays(cam, DofInfo(autofocus=False), w, h)
        compare(meta, arrays, wavefront_rays(meta, arrays, lights, ca, w, h),
                f"{label} {w}x{h}")
        fetch_exact(arrays, label)
    os.environ["PIM_TEST_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_bvh_kernel.py")])
    print(f"[kernels] gpu-marked tests: pytest exit {int(rc)}", flush=True)
    check(rc == 0, "gpu-marked tests")


# --- phases 3-4: the app's entry point ---------------------------------------


def run_engine(width: int, height: int, script: str, scene: str) -> None:
    import jax
    import numpy as np

    from pim.app import Engine
    from pim.core.cmd import get_cmd_system
    from pim.render.render_system import _load_gate_band

    cmds = get_cmd_system()
    cmds.quit_requested = False
    cmds.error_count = 0
    eng = Engine(width=width, height=height)
    eng.init()
    frame_ms = []
    base_update = eng.update

    def timed_update():
        before = eng.render.sample_count
        t0 = time.perf_counter()
        base_update()
        if eng.render.sample_count > before:
            frame_ms.append((time.perf_counter() - t0) * 1e3)

    eng.update = timed_update
    rc = eng.run(script)
    rs = eng.render
    sd = rs.stddev()
    mean = float(np.asarray(rs.buffers.color).mean())
    band = _load_gate_band(rs.sample_count, scene, width / height)
    steady = frame_ms[2:] or frame_ms
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"[{scene}] {width}x{height} backend={rs.meta.backend} "
          f"gate={'ok' if rc == 0 else 'FAIL'} stddev={sd:.5f} mean={mean:.5f} "
          f"band(maxstddev, meanlo, meanhi)={band} frames={rs.sample_count} "
          f"first_frame_ms={frame_ms[0]:.1f} "
          f"median_ms_per_frame={float(np.median(steady)):.2f} "
          f"peak_bytes_in_use={peak}", flush=True)
    check(rc == 0, f"{scene} script exit {rc}")
    check(rs.meta.backend == "kernel", f"{scene} backend {rs.meta.backend}")


# --- phase 5: the differentiable step ----------------------------------------


def phase_train() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import cornell_scene
    from pim.render.camera import DofInfo, camera_arrays
    from pim.render.diff import extract_params, make_train_step

    (meta, arrays, lights), cam = cornell_scene()
    w = h = 128
    ca = camera_arrays(cam, DofInfo(autofocus=False), w, h)
    params = extract_params(meta, arrays, ca)
    init, step = make_train_step(meta, w, h, max_bounces=3)
    target = jnp.zeros((w * h, 3), jnp.float32)
    loss, new_params, _ = step(params, init(params), arrays, lights, ca,
                               target, jnp.uint32(0))
    moved = float(jnp.max(jnp.abs(new_params.mat_albedo - params.mat_albedo)))
    loss = float(jax.block_until_ready(loss))
    print(f"[train] cornell {w}x{h} backend={meta.backend} loss={loss:.6f} "
          f"max|d mat_albedo|={moved:.3e}", flush=True)
    check(np.isfinite(loss) and moved > 0.0, "train step")


# --- four cards ---------------------------------------------------------------


def phase_four() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from bench import MAX_BOUNCES, cornell_scene, e1m1_scene
    from pim.parallel.shard import make_sharded_render_step, make_sharded_train_step
    from pim.render.camera import DofInfo, camera_arrays
    from pim.render.diff import extract_params

    devs = jax.devices()
    meshes = {k: Mesh(np.asarray(devs[:k]), ("dp",)) for k in (4, 1)}

    (meta, arrays, lights), cam = e1m1_scene()
    ca = camera_arrays(cam, DofInfo(autofocus=False), E1M1_W, E1M1_H)
    out = {}
    for k, mesh in meshes.items():
        step = make_sharded_render_step(meta, mesh, E1M1_W, E1M1_H,
                                        max_bounces=MAX_BOUNCES)
        jax.block_until_ready(step(arrays, lights, ca, jnp.uint32(1)))
        t0 = time.perf_counter()
        color, _, _, live = jax.block_until_ready(
            step(arrays, lights, ca, jnp.uint32(0)))
        ms = (time.perf_counter() - t0) * 1e3
        out[k] = (float(jnp.mean(color)), np.asarray(live))
        print(f"[four] e1m1 {E1M1_W}x{E1M1_H} render on {k} card(s): "
              f"backend={meta.backend} mean={out[k][0]:.7f} "
              f"live_sum={int(out[k][1].sum())} frame_ms={ms:.1f}", flush=True)
    rel = abs(out[4][0] - out[1][0]) / abs(out[1][0])
    same_live = bool(np.array_equal(out[4][1], out[1][1]))
    print(f"[four] e1m1 image mean rel diff {rel:.3e}; live histogram "
          f"equal {same_live}", flush=True)
    check(rel <= 1e-4 and same_live, "sharded render vs one card")

    (meta, arrays, lights), cam = cornell_scene()
    w = h = 256
    ca = camera_arrays(cam, DofInfo(autofocus=False), w, h)
    params = extract_params(meta, arrays, ca)
    target = jnp.zeros((w * h, 3), jnp.float32)
    losses = {}
    for k, mesh in meshes.items():
        step = make_sharded_train_step(meta, mesh, w, h, max_bounces=3)
        loss, _, _ = step(params, arrays, lights, ca, target, jnp.uint32(0))
        losses[k] = float(loss)
    rel = abs(losses[4] - losses[1]) / abs(losses[1])
    print(f"[four] cornell {w}x{h} train loss 4 cards {losses[4]:.7f} vs "
          f"1 card {losses[1]:.7f}: rel diff {rel:.3e}", flush=True)
    check(np.isfinite(losses[4]) and rel <= 1e-4, "sharded train vs one card")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded path")
    args = ap.parse_args()
    os.chdir(ROOT)
    count = 4 if args.four else 1
    dev = phase_device(count)

    from pim.core.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.four:
        phase_four()
    else:
        phase_kernels()
        run_engine(E1M1_W, E1M1_H, "exec scripts/pt_test_e1m1.cmd", "e1m1")
        run_engine(CORNELL_RES, CORNELL_RES, "pt_test -frames 64", "cornell")
        phase_train()
    print(json.dumps({"ok": True, "device": dev}))


if __name__ == "__main__":
    main()
