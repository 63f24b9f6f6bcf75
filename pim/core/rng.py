"""Counter-based per-ray RNG streams (replacement for per-thread PCG).

The reference keeps one mutable `Prng` per worker thread, advanced with the
Jarzynski-Olano pcg4d permutation (ref: src/math/pcg.h:126-176,
src/common/random.c:67).  In the wavefront there are no threads — every ray owns a
4-lane uint32 state, seeded by hashing (pixel_id, sample_id, seed), so
results are deterministic under any sharding of the ray axis.

Layout note: state is a NamedTuple of four flat [N] uint32 arrays (SoA),
like every per-lane value (see math/vec3.py).

All draw helpers are functional: (state) -> (new_state, values).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

_MUL = jnp.uint32(1664525)
_ADD = jnp.uint32(1013904223)


class RngState(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray
    w: jnp.ndarray


def _pcg4d_comps(x, y, z, w):
    """Jarzynski-Olano pcg4d on separate component arrays
    (matches ref Pcg4, src/math/pcg.h:126-176)."""
    x = x * _MUL + _ADD
    y = y * _MUL + _ADD
    z = z * _MUL + _ADD
    w = w * _MUL + _ADD
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return x, y, z, w


def pcg4d(v: jnp.ndarray) -> jnp.ndarray:
    """AoS convenience: [..., 4] uint32 -> [..., 4] (used by tests/edges)."""
    v = v.astype(jnp.uint32)
    x, y, z, w = _pcg4d_comps(v[..., 0], v[..., 1], v[..., 2], v[..., 3])
    return jnp.stack([x, y, z, w], axis=-1)


def pcg1(v: jnp.ndarray) -> jnp.ndarray:
    """Scalar PCG hash of uint32 (ref: src/math/pcg.h:26-32)."""
    v = v.astype(jnp.uint32)
    v = v * jnp.uint32(747796405) + jnp.uint32(2891336453)
    v = ((v >> ((v >> 28) + jnp.uint32(4))) ^ v) * jnp.uint32(277803737)
    return (v >> 22) ^ v


def to_float(bits: jnp.ndarray) -> jnp.ndarray:
    """uint32 -> float32 in [0, 1); same mapping as ref Prng_ToFloat
    (src/common/random.h:108-111)."""
    return (bits >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


def make_state(pixel_id: jnp.ndarray, sample_id, seed=0x9E3779B9) -> RngState:
    """Seed per-ray streams from (pixel_id, sample_id, seed)."""
    pix = jnp.asarray(pixel_id, jnp.uint32)
    samp = jnp.broadcast_to(jnp.asarray(sample_id, jnp.uint32), pix.shape)
    sd = jnp.broadcast_to(jnp.asarray(seed, jnp.uint32), pix.shape)
    beef = jnp.full_like(pix, jnp.uint32(0xDEADBEEF))
    s = _pcg4d_comps(*_pcg4d_comps(pix, samp, sd, beef))
    return RngState(*s)


def next_state(state: RngState) -> RngState:
    return RngState(*_pcg4d_comps(*state))


def next_f32(state: RngState):
    state = next_state(state)
    return state, to_float(state.x)


def next_f32x2(state: RngState):
    """Returns (state, (u, v)) — a 2-tuple of [N] floats."""
    state = next_state(state)
    return state, (to_float(state.x), to_float(state.y))


def next_f32x3(state: RngState):
    state = next_state(state)
    return state, (to_float(state.x), to_float(state.y), to_float(state.z))


def next_f32x4(state: RngState):
    state = next_state(state)
    return state, (
        to_float(state.x), to_float(state.y), to_float(state.z), to_float(state.w)
    )


def next_u32(state: RngState):
    state = next_state(state)
    return state, state.x
