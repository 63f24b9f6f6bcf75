"""Ray-scene intersection backends (the Embree replacement).

Replaces rtcIntersect1/rtcOccluded16 (ref: src/rendering/path_tracer.c:
448-553) with XLA intersectors over the flat SoA scene:

- `brute`: dense Möller-Trumbore of every ray against every triangle,
  blocked over triangle chunks with a `lax.scan` min-reduction; the
  correctness oracle for everything else.
- `bvh`: vectorized stack traversal of the host-built SAH BVH
  (lockstep `while_loop`, per-ray stacks in device memory).  The CPU path
  for big scenes, and the reference the GPU traversal kernel
  (render/bvh_kernel.py) is checked against.

Hit convention matches the reference (path_tracer.c:1421-1464):
  t < 0      -> miss
  front/back  -> backface flag from the geometric normal vs ray dir
  ng          -> unit geometric normal flipped to oppose the ray
  (w, u, v)   -> barycentric weights, hit = w*A + u*B + v*C
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from pim.math.vec3 import V3


class Hit(NamedTuple):
    t: jnp.ndarray        # [N] f32, <0 on miss
    tri: jnp.ndarray      # [N] i32 triangle index, -1 on miss
    u: jnp.ndarray        # [N] f32 barycentric u (weight of vertex B)
    v: jnp.ndarray        # [N] f32 barycentric v (weight of vertex C)
    backface: jnp.ndarray  # [N] bool
    ng: V3                # unit geometric normal (SoA), faces the ray origin


TRI_CHUNK = 512


def _moller_trumbore(ro, rd, a, e1, e2):
    """Batched two-sided Möller-Trumbore.

    ro/rd: [N, 1, 3]; a/e1/e2: [1, C, 3] (or broadcastable).
    Returns (t, u, v, det) each [N, C].
    """
    pvec = jnp.cross(rd, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = ro - a
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(rd * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    return t, u, v, det


def _tri_verts(positions, tri_idx):
    """Gather triangle vertices: positions [V, 3], tri_idx [...] -> a, b, c."""
    base = tri_idx * 3
    a = positions[base]
    b = positions[base + 1]
    c = positions[base + 2]
    return a, b, c


# ---------------------------------------------------------------------------
# Brute-force backend
# ---------------------------------------------------------------------------


def intersect_brute(positions: jnp.ndarray, ro: jnp.ndarray, rd: jnp.ndarray,
                    t_near, t_far) -> Hit:
    """Closest-hit over all triangles. positions [V,3]; ro/rd [N,3]."""
    tri_count = positions.shape[0] // 3
    n = ro.shape[0]
    tris = positions[: tri_count * 3].reshape(tri_count, 3, 3)
    a_all = tris[:, 0]
    e1_all = tris[:, 1] - tris[:, 0]
    e2_all = tris[:, 2] - tris[:, 0]

    # pad to chunk multiple with degenerate triangles
    chunk = min(TRI_CHUNK, max(tri_count, 1))
    pad = (-tri_count) % chunk
    if pad:
        z = jnp.zeros((pad, 3), positions.dtype)
        a_all = jnp.concatenate([a_all, z])
        e1_all = jnp.concatenate([e1_all, z])
        e2_all = jnp.concatenate([e2_all, z])
    num_chunks = a_all.shape[0] // chunk
    a_all = a_all.reshape(num_chunks, chunk, 3)
    e1_all = e1_all.reshape(num_chunks, chunk, 3)
    e2_all = e2_all.reshape(num_chunks, chunk, 3)

    t_near = jnp.broadcast_to(jnp.asarray(t_near, jnp.float32), (n,))
    t_far = jnp.broadcast_to(jnp.asarray(t_far, jnp.float32), (n,))

    ro_b = ro[:, None, :]
    rd_b = rd[:, None, :]

    def body(carry, chunk_data):
        best_t, best_tri, best_u, best_v, best_det = carry
        a, e1, e2, base = chunk_data
        t, u, v, det = _moller_trumbore(ro_b, rd_b, a[None], e1[None], e2[None])
        valid = (
            (jnp.abs(det) > 1e-12)
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > t_near[:, None])
            & (t < best_t[:, None])
        )
        t = jnp.where(valid, t, jnp.inf)
        j = jnp.argmin(t, axis=-1)
        rows = jnp.arange(t.shape[0])
        tj = t[rows, j]
        better = tj < best_t
        best_tri = jnp.where(better, base + j.astype(jnp.int32), best_tri)
        best_u = jnp.where(better, u[rows, j], best_u)
        best_v = jnp.where(better, v[rows, j], best_v)
        best_det = jnp.where(better, det[rows, j], best_det)
        best_t = jnp.where(better, tj, best_t)
        return (best_t, best_tri, best_u, best_v, best_det), None

    init = (
        t_far,
        jnp.full((n,), -1, jnp.int32),
        jnp.zeros((n,), jnp.float32),
        jnp.zeros((n,), jnp.float32),
        jnp.zeros((n,), jnp.float32),
    )
    bases = jnp.arange(num_chunks, dtype=jnp.int32) * chunk
    (best_t, best_tri, best_u, best_v, best_det), _ = jax.lax.scan(
        body, init, (a_all, e1_all, e2_all, bases)
    )
    return _finalize_hit(positions, best_t, best_tri, best_u, best_v, best_det, t_far, rd)


def _finalize_hit(positions, t, tri, u, v, det, t_far, rd) -> Hit:
    miss = (tri < 0) | (t >= t_far)
    safe_tri = jnp.maximum(tri, 0)
    a, b, c = _tri_verts(positions, safe_tri)
    ng = jnp.cross(b - a, c - a)
    # det = dot(e1, cross(rd, e2)) = -dot(rd, ng): det < 0 <=> backface
    backface = det < 0.0
    inv_len = 1.0 / jnp.sqrt(jnp.maximum(jnp.sum(ng * ng, -1), 1e-24))
    sign = jnp.where(miss, 0.0, jnp.where(backface, -inv_len, inv_len))
    u = jnp.clip(u, 0.0, 1.0)
    v = jnp.clip(v, 0.0, 1.0)
    return Hit(
        t=jnp.where(miss, -1.0, t),
        tri=jnp.where(miss, -1, tri),
        u=jnp.where(miss, 0.0, u),
        v=jnp.where(miss, 0.0, v),
        backface=jnp.where(miss, False, backface),
        ng=V3(ng[:, 0] * sign, ng[:, 1] * sign, ng[:, 2] * sign),
    )


def occluded_brute(positions: jnp.ndarray, ro: jnp.ndarray, rd: jnp.ndarray,
                   t_near, t_far) -> jnp.ndarray:
    """Any-hit: True where the segment [t_near, t_far] is blocked."""
    hit = intersect_brute(positions, ro, rd, t_near, t_far)
    return hit.t >= 0.0


# ---------------------------------------------------------------------------
# BVH backend: lockstep stack traversal
# ---------------------------------------------------------------------------

STACK_DEPTH = 48


def _slab_test(lo, hi, ro, inv_rd, t_near, t_far):
    """Ray-AABB slab test. lo/hi/ro/inv_rd [..., 3] -> (hit, t_entry)."""
    t0 = (lo - ro) * inv_rd
    t1 = (hi - ro) * inv_rd
    tmin = jnp.minimum(t0, t1)
    tmax = jnp.maximum(t0, t1)
    entry = jnp.maximum(jnp.max(tmin, axis=-1), t_near)
    exit_ = jnp.minimum(jnp.min(tmax, axis=-1), t_far)
    return entry <= exit_, entry


@partial(jax.jit, static_argnames=("max_leaf", "any_hit"))
def _traverse(node_lo, node_hi, node_a, node_b, tri_order, positions,
              ro, rd, t_near, t_far, max_leaf: int, any_hit: bool):
    """Lockstep BVH traversal for a ray batch.

    Every ray keeps its own node stack; each while-loop iteration pops one
    node per ray, gathers bounds/children, and either pushes children
    (near-first) or tests the leaf's triangles (padded to max_leaf).
    """
    n = ro.shape[0]
    inv_rd = jnp.where(jnp.abs(rd) > 1e-12, 1.0 / rd, jnp.float32(1e12))

    t_near = jnp.broadcast_to(jnp.asarray(t_near, jnp.float32), (n,))
    t_far = jnp.broadcast_to(jnp.asarray(t_far, jnp.float32), (n,))

    stack = jnp.zeros((n, STACK_DEPTH), jnp.int32)
    sp = jnp.ones((n,), jnp.int32)  # root pre-pushed at slot 0

    state = dict(
        stack=stack, sp=sp,
        best_t=t_far,
        best_tri=jnp.full((n,), -1, jnp.int32),
        best_u=jnp.zeros((n,), jnp.float32),
        best_v=jnp.zeros((n,), jnp.float32),
        best_det=jnp.zeros((n,), jnp.float32),
    )

    def cond(state):
        return jnp.any(state["sp"] > 0)

    def body(state):
        sp = state["sp"]
        active = sp > 0
        sp_idx = jnp.maximum(sp - 1, 0)
        node = state["stack"][jnp.arange(n), sp_idx]
        sp = jnp.where(active, sp - 1, sp)

        lo = node_lo[node]
        hi = node_hi[node]
        na = node_a[node]
        nb = node_b[node]
        hit_box, _ = _slab_test(lo, hi, ro, inv_rd, t_near, state["best_t"])
        hit_box = hit_box & active
        is_leaf = nb < 0

        # --- internal: push both children, near one on top -----------------
        push = hit_box & ~is_leaf
        lo_a = node_lo[jnp.maximum(na, 0)]
        hi_a = node_hi[jnp.maximum(na, 0)]
        lo_b = node_lo[jnp.maximum(nb, 0)]
        hi_b = node_hi[jnp.maximum(nb, 0)]
        _, entry_a = _slab_test(lo_a, hi_a, ro, inv_rd, t_near, state["best_t"])
        _, entry_b = _slab_test(lo_b, hi_b, ro, inv_rd, t_near, state["best_t"])
        a_first = entry_a <= entry_b
        first = jnp.where(a_first, na, nb)
        second = jnp.where(a_first, nb, na)
        stack = state["stack"]
        rows = jnp.arange(n)
        # push far child then near child (near is popped first)
        stack = stack.at[rows, jnp.where(push, sp, 0)].set(
            jnp.where(push, second, stack[rows, 0])
        )
        sp1 = jnp.where(push, sp + 1, sp)
        stack = stack.at[rows, jnp.where(push, sp1, 0)].set(
            jnp.where(push, first, stack[rows, 0])
        )
        sp2 = jnp.where(push, sp1 + 1, sp1)

        # --- leaf: test up to max_leaf triangles ---------------------------
        do_leaf = hit_box & is_leaf
        first_slot = na
        count = jnp.where(is_leaf, ~nb, 0)
        best_t = state["best_t"]
        best_tri = state["best_tri"]
        best_u = state["best_u"]
        best_v = state["best_v"]
        best_det = state["best_det"]
        k = jnp.arange(max_leaf)
        slot = first_slot[:, None] + k[None, :]
        slot_valid = (k[None, :] < count[:, None]) & do_leaf[:, None]
        tri_idx = tri_order[jnp.clip(slot, 0, tri_order.shape[0] - 1)]
        a, b, c = _tri_verts(positions, tri_idx)
        t, u, v, det = _moller_trumbore(
            ro[:, None, :], rd[:, None, :], a, b - a, c - a
        )
        valid = (
            slot_valid
            & (jnp.abs(det) > 1e-12)
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > t_near[:, None])
            & (t < best_t[:, None])
        )
        t = jnp.where(valid, t, jnp.inf)
        j = jnp.argmin(t, axis=-1)
        tj = t[rows, j]
        better = tj < best_t
        best_tri = jnp.where(better, tri_idx[rows, j], best_tri)
        best_u = jnp.where(better, u[rows, j], best_u)
        best_v = jnp.where(better, v[rows, j], best_v)
        best_det = jnp.where(better, det[rows, j], best_det)
        best_t = jnp.where(better, tj, best_t)

        if any_hit:
            # occlusion query: a hit empties the stack (early out)
            found = best_tri >= 0
            sp2 = jnp.where(found, 0, sp2)

        return dict(
            stack=stack, sp=sp2, best_t=best_t, best_tri=best_tri,
            best_u=best_u, best_v=best_v, best_det=best_det,
        )

    state = jax.lax.while_loop(cond, body, state)
    return (
        state["best_t"], state["best_tri"], state["best_u"],
        state["best_v"], state["best_det"],
    )


def intersect_bvh(bvh, positions, ro, rd, t_near, t_far, max_leaf: int = 4) -> Hit:
    n = ro.shape[0]
    t_far_b = jnp.broadcast_to(jnp.asarray(t_far, jnp.float32), (n,))
    t, tri, u, v, det = _traverse(
        bvh.node_lo, bvh.node_hi, bvh.node_a, bvh.node_b, bvh.tri_order,
        positions, ro, rd, t_near, t_far_b, max_leaf=max_leaf, any_hit=False,
    )
    return _finalize_hit(positions, t, tri, u, v, det, t_far_b, rd)


def occluded_bvh(bvh, positions, ro, rd, t_near, t_far, max_leaf: int = 4) -> jnp.ndarray:
    n = ro.shape[0]
    t_far_b = jnp.broadcast_to(jnp.asarray(t_far, jnp.float32), (n,))
    _, tri, _, _, _ = _traverse(
        bvh.node_lo, bvh.node_hi, bvh.node_a, bvh.node_b, bvh.tri_order,
        positions, ro, rd, t_near, t_far_b, max_leaf=max_leaf, any_hit=True,
    )
    return tri >= 0
