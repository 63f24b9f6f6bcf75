"""Check sample-to-sample decorrelation of the integrator (GPU or CPU).

Prints the mean off-diagonal correlation of 16 one-sample images and the
variance-reduction ratio raw vs luminance-clipped.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from pim.core import rng
from pim.geom.cornell import build_cornell_box
from pim.render.camera import Camera, DofInfo, camera_arrays, generate_primary_rays
from pim.render.integrator import trace_rays
from pim.render.scene import build_scene

n = 24
ents, pool = build_cornell_box("boxes")
meta, arrays, lights = build_scene(ents, pool, backend="brute")
cam = Camera(position=np.array([-4, 0, 4], np.float32))
cam.look_at([0, -1, 0])
ca = camera_arrays(cam, DofInfo(autofocus=False), n, n)


@jax.jit
def step(sample):
    state = rng.make_state(jnp.arange(n * n, dtype=jnp.uint32), sample)
    state, ro, rd = generate_primary_rays(ca, n, n, state)
    return trace_rays(meta, arrays, lights, ro, rd, state, max_bounces=4).color


imgs = np.stack([np.asarray(step(jnp.uint32(s))) for s in range(16)])  # [16, N, 3]
flat = imgs.reshape(16, -1)
dev = flat - flat.mean(axis=0, keepdims=True)
c = np.corrcoef(dev)
off = c[~np.eye(16, dtype=bool)]
print(f"max |offdiag corr| {np.abs(off).max():.3f}  mean {off.mean():.4f}")
print(f"img max value {imgs.max():.1f}, 99.9pct {np.percentile(imgs, 99.9):.2f}")

for tag, im in (("raw", imgs), ("clip5", np.clip(imgs, 0, 5.0))):
    singles = im[:4]
    means4 = np.stack([im[4 * g : 4 * g + 4].mean(axis=0) for g in range(4)])
    vs = np.var(singles, axis=0).mean()
    vm = np.var(means4, axis=0).mean()
    print(f"{tag}: var_single {vs:.4f}  var_mean4 {vm:.4f}  ratio {vs/max(vm,1e-12):.2f}")
