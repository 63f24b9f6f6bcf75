"""Per-ray BVH traversal kernel for the GPU (Pallas, Triton route).

Closest-hit and any-hit over the host-built SAH BVH (geom/bvh.py), the
per-ray form of what Embree runs per CPU lane (ref rtcIntersect1 /
rtcOccluded16, src/rendering/path_tracer.c:448-553).  One ray per lane,
BLOCK rays per program; every lane walks the tree on its own:

  * the node stack is STACK lanes of int32 held in registers (one [BLOCK]
    vector per depth slot, pushed and popped with `where`), sized from the
    tree's depth so it cannot overflow;
  * a node's two child boxes are tested together; the nearer hit child is
    taken next and the farther one pushed, so a pop happens only after a
    leaf or a double miss;
  * node bounds, children and leaf triangles are gathered straight from
    global memory (masked loads; e1m1's tree plus vertices is ~10 MB and
    stays in L2), nothing is staged in shared memory;
  * a program loops until every lane of its block has retired, so a block
    of short rays does not wait for the wavefront's deepest ray;
  * any-hit retires a lane at its first hit inside [t_near, t_far];
  * dead lanes (t_far <= 0, the integrator's contract) never enter.

The triangle test is the same two-sided Möller-Trumbore as
render/intersect.py, in float32 with no matrix product (so TF32 does not
apply).  render/intersect.py's `_traverse` (an XLA lockstep loop over the
whole wavefront) and `intersect_brute` are the references.

The outputs (t, tri) carry no gradient: the inputs are cut with
stop_gradient and scene._finalize_hit_fused recomputes t, u, v from the
fetched vertices, which is where the differentiable path gets its
derivatives.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from pim.render.platform import pallas_interpret

BLOCK = 32        # rays per program: one warp, one ray per thread
NUM_WARPS = 1


def _slab(lo, hi, ro, inv, t_near, t_far):
    """Ray-box slab test on per-lane component lists -> (hit, entry)."""
    tmin = t_near
    tmax = t_far
    for c in range(3):
        t0 = (lo[c] - ro[c]) * inv[c]
        t1 = (hi[c] - ro[c]) * inv[c]
        tmin = jnp.maximum(tmin, jnp.minimum(t0, t1))
        tmax = jnp.minimum(tmax, jnp.maximum(t0, t1))
    return tmin <= tmax, tmin


def _kernel(lo_ref, hi_ref, a_ref, b_ref, order_ref, pos_ref,
            rox_ref, roy_ref, roz_ref, rdx_ref, rdy_ref, rdz_ref,
            tn_ref, tf_ref, t_out, tri_out, *, stack: int, max_leaf: int,
            any_hit: bool):
    def gather(ref, idx, mask, other):
        return plgpu.load(ref.at[jnp.where(mask, idx, 0)], mask=mask,
                          other=other)

    ro = (rox_ref[...], roy_ref[...], roz_ref[...])
    rd = (rdx_ref[...], rdy_ref[...], rdz_ref[...])
    t_near = tn_ref[...]
    t_far = tf_ref[...]
    inv = tuple(jnp.where(jnp.abs(d) > 1e-12, 1.0 / d, jnp.float32(1e12))
                for d in rd)
    zero_i = jnp.zeros_like(t_far, jnp.int32)
    alive = t_far > 0.0

    def box(node, mask, best_t):
        lo = [gather(lo_ref, node * 3 + c, mask, 0.0) for c in range(3)]
        hi = [gather(hi_ref, node * 3 + c, mask, 0.0) for c in range(3)]
        hit, entry = _slab(lo, hi, ro, inv, t_near, best_t)
        return hit & mask, entry

    root_hit, _ = box(zero_i, alive, t_far)
    init = (jnp.where(root_hit, 0, -1), zero_i, t_far, zero_i - 1,
            *([zero_i] * stack))

    def cond(carry):
        cur, sp = carry[0], carry[1]
        return jnp.max(jnp.where((cur >= 0) | (sp > 0), 1, 0)) > 0

    def body(carry):
        cur, sp, best_t, best_tri = carry[:4]
        slots = list(carry[4:])
        # pop when the lane has no current node
        need_pop = (cur < 0) & (sp > 0)
        top = sp - 1
        popped = slots[0]
        for k in range(1, stack):
            popped = jnp.where(top == k, slots[k], popped)
        cur = jnp.where(need_pop, popped, cur)
        sp = jnp.where(need_pop, top, sp)
        active = cur >= 0

        na = gather(a_ref, cur, active, 0)
        nb = gather(b_ref, cur, active, -1)
        leaf = nb < 0
        inner = active & ~leaf

        # internal: test both children, go to the nearer, push the farther
        hit_a, ea = box(na, inner, best_t)
        hit_b, eb = box(nb, inner, best_t)
        a_first = ea <= eb
        near = jnp.where(a_first, na, nb)
        far = jnp.where(a_first, nb, na)
        near_hit = jnp.where(a_first, hit_a, hit_b)
        far_hit = jnp.where(a_first, hit_b, hit_a)
        both = near_hit & far_hit
        for k in range(stack):
            slots[k] = jnp.where(both & (sp == k), far, slots[k])
        sp = jnp.where(both, sp + 1, sp)
        nxt = jnp.where(near_hit, near, jnp.where(far_hit, far, -1))

        # leaf: up to max_leaf triangles from contiguous slots
        do_leaf = active & leaf
        count = ~nb
        for k in range(max_leaf):
            m = do_leaf & (k < count)
            tri = gather(order_ref, na + k, m, 0)
            v = [[gather(pos_ref, (tri * 3 + j) * 3 + c, m, 0.0)
                  for c in range(3)] for j in range(3)]
            e1 = [v[1][c] - v[0][c] for c in range(3)]
            e2 = [v[2][c] - v[0][c] for c in range(3)]
            p = [rd[1] * e2[2] - rd[2] * e2[1],
                 rd[2] * e2[0] - rd[0] * e2[2],
                 rd[0] * e2[1] - rd[1] * e2[0]]
            det = e1[0] * p[0] + e1[1] * p[1] + e1[2] * p[2]
            ok_det = jnp.abs(det) > 1e-12
            inv_det = jnp.where(ok_det, 1.0 / jnp.where(ok_det, det, 1.0), 0.0)
            tv = [ro[c] - v[0][c] for c in range(3)]
            u = (tv[0] * p[0] + tv[1] * p[1] + tv[2] * p[2]) * inv_det
            q = [tv[1] * e1[2] - tv[2] * e1[1],
                 tv[2] * e1[0] - tv[0] * e1[2],
                 tv[0] * e1[1] - tv[1] * e1[0]]
            vv = (rd[0] * q[0] + rd[1] * q[1] + rd[2] * q[2]) * inv_det
            t = (e2[0] * q[0] + e2[1] * q[1] + e2[2] * q[2]) * inv_det
            valid = (m & ok_det & (u >= 0.0) & (vv >= 0.0) & (u + vv <= 1.0)
                     & (t > t_near) & (t < best_t))
            best_t = jnp.where(valid, t, best_t)
            best_tri = jnp.where(valid, tri, best_tri)

        cur = jnp.where(inner, nxt, -1)
        if any_hit:
            found = best_tri >= 0
            cur = jnp.where(found, -1, cur)
            sp = jnp.where(found, 0, sp)
        return (cur, sp, best_t, best_tri, *slots)

    out = jax.lax.while_loop(cond, body, init)
    best_t, best_tri = out[2], out[3]
    t_out[...] = jnp.where(best_tri >= 0, best_t, -1.0)
    tri_out[...] = best_tri


def bvh_depth(node_a: np.ndarray, node_b: np.ndarray) -> int:
    """Edges on the longest root-to-leaf path: the traversal's stack bound
    (the stack holds at most one pending sibling per level)."""
    node_a = np.asarray(node_a)
    node_b = np.asarray(node_b)
    frontier = np.zeros(1, np.int64)
    depth = 0
    while True:
        inner = frontier[node_b[frontier] >= 0]
        if inner.size == 0:
            return depth
        frontier = np.concatenate([node_a[inner], node_b[inner]])
        depth += 1


@functools.partial(jax.jit, static_argnames=("stack", "max_leaf", "any_hit",
                                             "interpret"))
def _traverse_call(node_lo, node_hi, node_a, node_b, tri_order, positions,
                   rays, *, stack, max_leaf, any_hit, interpret):
    n = rays[0].shape[0]
    npad = -(-n // BLOCK) * BLOCK
    # padded lanes are dead: t_far = 0
    rays = [jnp.pad(r, (0, npad - n)) for r in rays]
    kernel = functools.partial(_kernel, stack=max(stack, 1),
                               max_leaf=max_leaf, any_hit=any_hit)
    whole = pl.no_block_spec
    lane = pl.BlockSpec((BLOCK,), lambda i: (i,))
    t, tri = pl.pallas_call(
        kernel,
        grid=(npad // BLOCK,),
        in_specs=[whole] * 6 + [lane] * 8,
        out_specs=[lane, lane],
        out_shape=[jax.ShapeDtypeStruct((npad,), jnp.float32),
                   jax.ShapeDtypeStruct((npad,), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="bvh_any_hit" if any_hit else "bvh_closest_hit",
    )(node_lo.reshape(-1), node_hi.reshape(-1), node_a, node_b, tri_order,
      positions.reshape(-1), *rays)
    return t[:n], tri[:n]


def traverse(bvh, positions, ro, rd, t_near, t_far, *, stack: int,
             max_leaf: int, any_hit: bool):
    """BVH traversal kernel: bvh = (node_lo, node_hi, node_a, node_b,
    tri_order); ro/rd V3 of [N]; t_near/t_far scalars or [N].  Compiled
    on the GPU, interpreted on the CPU (render/platform.py).
    Returns (t [N] f32, -1 on miss; tri [N] i32, -1 on miss)."""
    n = ro.x.shape[0]
    if positions.shape[0] == 0:  # empty scene: every lane misses
        return jnp.full((n,), -1.0, jnp.float32), jnp.full((n,), -1, jnp.int32)
    sg = jax.lax.stop_gradient
    rays = [sg(jnp.broadcast_to(jnp.asarray(x, jnp.float32), (n,)))
            for x in (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, t_near, t_far)]
    return _traverse_call(*map(sg, bvh), sg(positions), rays, stack=stack,
                          max_leaf=max_leaf, any_hit=any_hit,
                          interpret=pallas_interpret())
