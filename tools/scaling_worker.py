"""One process of the multi-host scaling harness.

Launched by tools/scaling_bench.py with PIM_PROC_ID/PIM_NUM_PROCS/
PIM_COORDINATOR set.  Joins the jax.distributed world, builds the Cornell
scene (replicated), renders a 'dp'-sharded progressive frame over the
GLOBAL mesh (weak scaling: per-process pixel count is fixed), and rank 0
prints one JSON line with the timing.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    base_w = int(os.environ.get("PIM_SCALE_W", "64"))
    base_h = int(os.environ.get("PIM_SCALE_H", "64"))
    steps = int(os.environ.get("PIM_SCALE_STEPS", "8"))
    bounces = int(os.environ.get("PIM_SCALE_BOUNCES", "3"))
    devs_per_proc = int(os.environ.get("PIM_DEVS_PER_PROC", "1"))
    if devs_per_proc > 1:
        # multi-card-per-host worlds:
        # virtual CPU devices federate through the same mesh machinery
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count={devs_per_proc}"
        ).strip()

    from pim.parallel.dist import global_mesh, init_distributed, replicate

    info = init_distributed()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from pim.geom.cornell import build_cornell_box
    from pim.parallel.shard import make_sharded_render_step
    from pim.render.camera import Camera, DofInfo, camera_arrays
    from pim.render.scene import build_scene

    if os.environ.get("PIM_SCALE_MODE") == "lmbake":
        return lmbake_main(info, steps)

    mesh = global_mesh()
    n_dev = mesh.devices.size

    # weak scaling: H grows with the world so each process keeps base_w*base_h
    width = base_w
    height = base_h * info.num_processes

    ents, pool = build_cornell_box("boxes")
    meta, arrays, lights = build_scene(ents, pool, backend="auto")
    cam = Camera(position=np.array([-4, 0, 4], np.float32))
    cam.look_at([0, -1, 0])
    ca = camera_arrays(cam, DofInfo(autofocus=False), width, height)

    arrays, lights, ca = replicate((arrays, lights, ca), mesh)
    step = make_sharded_render_step(meta, mesh, width, height,
                                    max_bounces=bounces)

    for i in range(2):
        color, _, _, live = step(arrays, lights, ca, jnp.uint32(i))
    color.block_until_ready()

    if info.num_processes > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("scale-timer-start")

    t0 = time.perf_counter()
    for i in range(steps):
        color, _, _, live = step(arrays, lights, ca, jnp.uint32(2 + i))
    color.block_until_ready()
    wall = time.perf_counter() - t0

    if info.is_main:
        n = width * height
        print(json.dumps({
            "nprocs": info.num_processes,
            "devices": int(n_dev),
            "pixels": n,
            "steps": steps,
            "bounces": bounces,
            "wall_s": round(wall, 4),
            "mpaths_per_s": round(n * steps / wall / 1e6, 4),
        }), flush=True)


def lmbake_main(info, steps):
    """Process-sharded progressive lightmap bake (BASELINE
    row 5 / ref Lightmap_Trace, render_system.c:181-213 + lightmap.c:
    1125-1201).  STRONG scaling over one map's texels: each rank bakes its
    contiguous slice of the texel axis — embarrassingly parallel, exactly
    like the reference's task-pool range claiming, with the per-texel
    (texel_id, frame)-seeded rng making the sharded bake bit-identical to
    an unsharded one (tests/test_lightmap.py shard-equivalence test).
    Rank 0 reports global texels/s; allgather_rows reassembles the pack
    for checkpoint (dist.py)."""
    import time as _time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from pim.core import cvars as cv
    from pim.geom.entities import flatten
    from pim.geom.maps import build_map_scene
    from pim.render import lightmap as lm
    from pim.render.scene import build_scene

    rooms = int(os.environ.get("PIM_SCALE_LM_ROOMS", "2"))
    density = float(os.environ.get("PIM_SCALE_LM_DENSITY", "4.0"))
    bounces = int(os.environ.get("PIM_SCALE_BOUNCES", "2"))

    ents, pool = build_map_scene(rooms=(rooms, rooms), spheres_per_room=2,
                                 sphere_steps=8, tex_size=16, seed=1)
    meta, arrays, lights = build_scene(ents, pool, backend="auto")
    flat = flatten(ents)
    pack = lm.pack_lightmaps(flat.positions, flat.normals,
                             texels_per_meter=density)
    t_total = pack.position.shape[1]
    per = -(-t_total // info.num_processes)
    off = info.process_id * per
    cnt = max(min(per, t_total - off), 0)

    p = pack
    p = lm.bake_step(meta, arrays, lights, p, 0, max_bounces=bounces,
                     texel_offset=off, texel_count=cnt)  # compile warmup
    jax.block_until_ready(p.probes)

    if info.num_processes > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("lmbake-start")
    t0 = _time.perf_counter()
    for f in range(1, steps + 1):
        p = lm.bake_step(meta, arrays, lights, p, f, max_bounces=bounces,
                         texel_offset=off, texel_count=cnt)
    jax.block_until_ready(p.probes)
    if info.num_processes > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("lmbake-end")
    wall = _time.perf_counter() - t0

    if info.is_main:
        print(json.dumps({
            "mode": "lmbake",
            "nprocs": info.num_processes,
            "devices": int(len(jax.devices())),
            "pixels": int(t_total),     # texels; bench reads this field
            "steps": steps,
            "bounces": bounces,
            "wall_s": round(wall, 4),
            "mpaths_per_s": round(t_total * steps / wall / 1e6, 4),
        }), flush=True)


if __name__ == "__main__":
    main()
