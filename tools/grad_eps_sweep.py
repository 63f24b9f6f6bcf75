"""FD-vs-AD convergence sweep for the roughness gradient (CPU, test config)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")

from pim.geom.cornell import build_cornell_box
from pim.render.camera import Camera, DofInfo, camera_arrays
from pim.render.diff import extract_params, make_loss_fn
from pim.render.scene import build_scene

W = H = 16
BOUNCES = 3
SEED = jnp.uint32(7)

ents, pool = build_cornell_box("boxes")
meta, arrays, lights = build_scene(ents, pool, backend="brute")
cam = Camera(position=np.array([-4, 0, 4], np.float32))
cam.look_at([0, -1, 0])
ca = camera_arrays(cam, DofInfo(autofocus=False), W, H)
params = extract_params(meta, arrays, ca)
loss = jax.jit(make_loss_fn(meta, W, H, max_bounces=BOUNCES))
args = (arrays, lights, ca, jnp.zeros((W * H, 3), jnp.float32), SEED)

d = jnp.zeros_like(params.mat_rome).at[:, 0].set(1.0)
v = jax.tree.map(jnp.zeros_like, params)._replace(mat_rome=d)

g = jax.grad(lambda p: loss(p, *args)[0])(params)
ad = sum(float(jnp.sum(a * b)) for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(v)))
print(f"AD {ad:+.6f}")

f64 = False
for eps in (2e-3, 5e-4, 1e-4, 2e-5, 5e-6):
    pp = jax.tree.map(lambda a, b: a + eps * b, params, v)
    pm = jax.tree.map(lambda a, b: a - eps * b, params, v)
    lp = float(loss(pp, *args)[0])
    lm = float(loss(pm, *args)[0])
    fd = (lp - lm) / (2 * eps)
    print(f"eps {eps:.0e}: FD {fd:+.6f}")
