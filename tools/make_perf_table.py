"""Per-kernel device time for bench.py's cells, from a profiler trace.

For each cell of bench.py (same scene, camera, step and sample count):
compile and warm the step, time one step on the host clock, then trace
`--steps` steps with jax.profiler and reduce the GPU device planes with
tools/analyze_trace.py: busy and idle share of the window and the kernels
by self time.  Writes a markdown section per cell (default stdout).

Usage: python tools/make_perf_table.py --trace-dir DIR [--steps 2]
                                       [--out perf_table.md]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))


def profile_cell(tag: str, steps: int, trace_dir: str) -> str:
    import jax
    import jax.numpy as jnp

    import bench
    from analyze_trace import busy_share, device_events, kernel_table
    from pim.render.camera import DofInfo, camera_arrays

    scene_fn, spp, exposure = bench.CELLS[tag]
    (meta, arrays, lights), cam = scene_fn()
    ca = camera_arrays(cam, DofInfo(autofocus=False), bench.WIDTH,
                       bench.HEIGHT)
    step = bench.make_step(meta, spp, exposure)
    jax.block_until_ready(step(arrays, lights, ca, jnp.uint32(0)))
    t0 = time.perf_counter()
    jax.block_until_ready(step(arrays, lights, ca, jnp.uint32(1)))
    wall_ms = (time.perf_counter() - t0) * 1e3
    shutil.rmtree(trace_dir, ignore_errors=True)
    with jax.profiler.trace(trace_dir):
        out = None
        for i in range(steps):
            out = step(arrays, lights, ca, jnp.uint32(2 + i))
        jax.block_until_ready(out)
    events = device_events(trace_dir)
    busy, window = busy_share(events)
    rows = kernel_table(events)
    total = sum(r[1] for r in rows)
    lines = [
        f"## {tag} ({meta.tri_count} tris, backend={meta.backend}, "
        f"{spp} spp/step)", "",
        f"Host wall per step (profiler off): {wall_ms:.3f} ms.  Traced "
        f"{steps} steps: device busy {busy / 1e6 / steps:.3f} ms/step, "
        f"idle share {1.0 - busy / max(window, 1.0):.4f} of the window.", "",
        "| kernel | ms/step | calls/step | % of device |",
        "|---|---|---|---|",
    ]
    for name, dur, c in rows[:25]:
        lines.append(f"| `{name[:60]}` | {dur / 1e6 / steps:.3f} | "
                     f"{c // steps} | {100 * dur / max(total, 1.0):.1f} |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace-dir", required=True,
                    help="where the profiler writes one trace per cell")
    args = ap.parse_args()
    os.chdir(ROOT)

    import bench
    from pim.core.compile_cache import enable_compile_cache
    from pim.core.device import card, require_gpu

    dev = require_gpu()
    enable_compile_cache()
    head = (f"Device: {dev['kind']} x{dev['count']}; card: {card()}; "
            f"{bench.WIDTH}x{bench.HEIGHT}, {bench.MAX_BOUNCES} bounces.")
    sections = [head] + [
        profile_cell(tag, args.steps, os.path.join(args.trace_dir, tag))
        for tag in bench.CELLS]
    text = "\n\n".join(sections) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
