"""A/B of the intersectors on the GPU, end to end.

Times bench.py's own step (Mrays/s) for each intersector of each cell,
all in one process on one card, in turns (A B C ... C B A) so drift in
clocks or power hits every variant alike:

  cornell512: kernel | bvh (XLA lockstep loop) | brute
  e1m1_512:   kernel | bvh

Each line names the card; with --log the JSON lines are also appended
to that file.

Usage: python tools/intersect_ab.py [--reps 2] [--log ab.jsonl]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = [  # (cell, intersector)
    ("cornell512", "kernel"),
    ("cornell512", "bvh"),
    ("cornell512", "brute"),
    ("e1m1_512", "kernel"),
    ("e1m1_512", "bvh"),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--log", default=None, help="append JSON lines here")
    args = ap.parse_args()
    os.chdir(ROOT)

    import jax
    import jax.numpy as jnp

    import bench
    from pim.core.compile_cache import enable_compile_cache
    from pim.core.device import card, require_gpu
    from pim.render.camera import DofInfo, camera_arrays

    dev = require_gpu()
    card_line = card()
    enable_compile_cache()
    log = open(args.log, "a") if args.log else None

    def out(rec):
        rec = {**rec, "card": card_line, "device": dev}
        line = json.dumps(rec)
        print(line, flush=True)
        if log:
            log.write(line + "\n")
            log.flush()

    prepared = []
    for cell, name in VARIANTS:
        scene_fn, spp, exposure = bench.CELLS[cell]
        (meta, arrays, lights), cam = scene_fn(backend=name)
        ca = camera_arrays(cam, DofInfo(autofocus=False), bench.WIDTH,
                           bench.HEIGHT)
        step = bench.make_step(meta, spp, exposure)
        t0 = time.perf_counter()
        jax.block_until_ready(step(arrays, lights, ca, jnp.uint32(0)))
        out({"cell": cell, "variant": name, "backend": meta.backend,
             "compile_and_first_step_s": time.perf_counter() - t0})
        prepared.append((cell, name, step, arrays, lights, ca))

    for rep in range(args.reps):
        order = prepared if rep % 2 == 0 else prepared[::-1]
        for cell, name, step, arrays, lights, ca in order:
            mrays, step_s, mean = bench._measure(step, arrays, lights, ca)
            out({"cell": cell, "variant": name, "rep": rep,
                 "mrays_per_s": mrays, "step_ms": step_s * 1e3,
                 "image_mean": mean,
                 "gate_ok": bench.check_gate(cell, mean)})
    if log:
        log.close()


if __name__ == "__main__":
    main()
