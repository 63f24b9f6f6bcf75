"""Measure (not assert) grad-all-reduce/backward overlap (SURVEY §2.9).

A/B on the sharded train step over an N-virtual-device mesh:
  A: default schedule — XLA may start each grad pmean as soon as that
     grad is final, overlapping collectives with the rest of the
     backward wavefront sweep.
  B: serialize_reduce=True — an optimization_barrier pins every pmean
     after the ENTIRE backward, the no-overlap control.

overlap benefit = (t_B - t_A) / t_B.  On virtual CPU devices the
collectives are shared-memory copies, so the measurable benefit bounds
from below what collectives between real cards gain; the point of
the artifact is that the schedule difference EXISTS and is timed, not
guessed.  Writes the result into SCALING.md's appendix.

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       JAX_PLATFORMS=cpu python tools/overlap_ab.py [res] [steps]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RES = int(sys.argv[1]) if len(sys.argv) > 1 else 32
STEPS = int(sys.argv[2]) if len(sys.argv) > 2 else 20


def main():
    import jax

    if os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from pim.geom.cornell import build_cornell_box
    from pim.parallel.shard import make_mesh, make_sharded_train_step
    from pim.render.camera import Camera, DofInfo, camera_arrays
    from pim.render.diff import extract_params
    from pim.render.scene import build_scene

    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev)
    ents, pool = build_cornell_box("boxes")
    meta, arrays, lights = build_scene(ents, pool, backend="brute")
    cam = Camera(position=np.array([-4, 0, 4], np.float32))
    cam.look_at([0, -1, 0])
    ca = camera_arrays(cam, DofInfo(autofocus=False), RES, RES)
    params = extract_params(meta, arrays, ca)
    target = jnp.zeros((RES * RES, 3), jnp.float32)

    results = {}
    for tag, serialize in [("overlapped", False), ("serialized", True)]:
        step = make_sharded_train_step(meta, mesh, RES, RES, max_bounces=3,
                                       serialize_reduce=serialize)
        loss, p, l = step(params, arrays, lights, ca, target, jnp.uint32(0))
        loss.block_until_ready()
        t0 = time.perf_counter()
        for i in range(STEPS):
            loss, p, l = step(params, arrays, lights, ca, target,
                              jnp.uint32(1 + i))
        loss.block_until_ready()
        dt = (time.perf_counter() - t0) / STEPS
        results[tag] = dt
        print(f"{tag}: {dt*1e3:.2f} ms/step (mesh={n_dev} devices, "
              f"{RES}x{RES})", flush=True)

    benefit = (results["serialized"] - results["overlapped"]) / results["serialized"]
    line = (f"Grad-reduce/backward overlap A/B (tools/overlap_ab.py, "
            f"{n_dev}-device mesh, {RES}²): overlapped "
            f"{results['overlapped']*1e3:.2f} ms/step vs serialized "
            f"{results['serialized']*1e3:.2f} ms/step -> "
            f"{benefit*100:+.1f}% from overlap.")
    print(line)
    if os.path.exists("SCALING.md"):
        with open("SCALING.md") as f:
            txt = f.read()
        marker = "## Overlap"
        block = (f"\n{marker}\n\n{line}\nCaveat: virtual CPU devices make "
                 "collectives shared-memory copies; this lower-bounds the "
                 "benefit collectives between real cards see.\n")
        if marker in txt:
            txt = txt[: txt.index(marker)] + block.lstrip("\n")
        else:
            txt += block
        with open("SCALING.md", "w") as f:
            f.write(txt)
        print("appended to SCALING.md")


if __name__ == "__main__":
    main()
