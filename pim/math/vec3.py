"""SoA vector types: V2/V3/V4 as tuples of flat [N] component arrays.

WHY: a flat [N] array is read and written with unit stride by every lane;
an [N, 3] array puts a 3-wide minor dim in every access and every fusion
boundary.  So the hot path carries vectors as NamedTuples of [N]
components; AoS arrays appear only at API edges (images, tables).

Operators are overloaded for readability: `V3 + V3`, `V3 * scalar`,
`V3 * V3` (componentwise) all work; `dot/cross/normalize/...` live here.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import jax.numpy as jnp

Scalar = jnp.ndarray

EPS = jnp.float32(1e-6)
EPS_SQ = jnp.float32(1e-12)
RCP_EPS = jnp.float32(1e6)
MILLI = jnp.float32(1e-3)
PI = jnp.float32(3.14159265358979323846)
TAU = jnp.float32(6.28318530717958647692)
LOG2_EPS = jnp.float32(-19.931568569324174)
SQRT5_CONJ = jnp.float32(0.61803398875)


class V2(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray

    def __add__(self, o):
        if isinstance(o, V2):
            return V2(self.x + o.x, self.y + o.y)
        return V2(self.x + o, self.y + o)

    def __sub__(self, o):
        if isinstance(o, V2):
            return V2(self.x - o.x, self.y - o.y)
        return V2(self.x - o, self.y - o)

    def __mul__(self, o):
        if isinstance(o, V2):
            return V2(self.x * o.x, self.y * o.y)
        return V2(self.x * o, self.y * o)

    __rmul__ = __mul__

    @staticmethod
    def from_aos(arr):
        return V2(arr[..., 0], arr[..., 1])

    def aos(self):
        return jnp.stack([self.x, self.y], axis=-1)


class V3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    @staticmethod
    def from_aos(arr):
        return V3(arr[..., 0], arr[..., 1], arr[..., 2])

    @staticmethod
    def splat(v, shape=()):
        a = jnp.broadcast_to(jnp.float32(v[0]), shape)
        b = jnp.broadcast_to(jnp.float32(v[1]), shape)
        c = jnp.broadcast_to(jnp.float32(v[2]), shape)
        return V3(a, b, c)

    @staticmethod
    def zeros(shape=()):
        z = jnp.zeros(shape, jnp.float32)
        return V3(z, z, z)

    @staticmethod
    def ones(shape=()):
        o = jnp.ones(shape, jnp.float32)
        return V3(o, o, o)

    def aos(self):
        return jnp.stack([self.x, self.y, self.z], axis=-1)


class V4(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray
    w: jnp.ndarray

    @staticmethod
    def from_aos(arr):
        return V4(arr[..., 0], arr[..., 1], arr[..., 2], arr[..., 3])

    def aos(self):
        return jnp.stack([self.x, self.y, self.z, self.w], axis=-1)

    @property
    def xyz(self):
        return V3(self.x, self.y, self.z)


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def dot2(a: V2, b: V2):
    return a.x * b.x + a.y * b.y


def dotsat(a: V3, b: V3):
    return jnp.clip(dot(a, b), 0.0, 1.0)


def length(v: V3):
    return jnp.sqrt(jnp.maximum(dot(v, v), EPS_SQ))


def normalize(v: V3) -> V3:
    return v * jax_rsqrt(jnp.maximum(dot(v, v), EPS_SQ))


def jax_rsqrt(x):
    import jax

    return jax.lax.rsqrt(x)


def cross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def reflect(i: V3, n: V3) -> V3:
    return i - n * (2.0 * dot(i, n))


def refract(i: V3, n: V3, eta) -> V3:
    """GLSL refract; returns zeros on total internal reflection."""
    cosi = -dot(i, n)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    out = i * eta + n * (eta * cosi - jnp.sqrt(jnp.maximum(k, 0.0)))
    zero = jnp.float32(0.0)
    return V3(
        jnp.where(tir, zero, out.x),
        jnp.where(tir, zero, out.y),
        jnp.where(tir, zero, out.z),
    )


def lerp(a, b, t):
    return a + (b - a) * t


def lerp3(a: V3, b: V3, t) -> V3:
    return a + (b - a) * t


def where3(mask, a: V3, b: V3) -> V3:
    return V3(
        jnp.where(mask, a.x, b.x),
        jnp.where(mask, a.y, b.y),
        jnp.where(mask, a.z, b.z),
    )


def saturate(x):
    return jnp.clip(x, 0.0, 1.0)


def blend3(a: V3, b: V3, c: V3, w, u, v) -> V3:
    return a * w + b * u + c * v


def tri_area(a: V3, b: V3, c: V3):
    return 0.5 * length(cross(b - a, c - a))


def avg_lum3(c: V3):
    return (c.x + c.y + c.z) * jnp.float32(1.0 / 3.0)


def max3(c: V3):
    return jnp.maximum(c.x, jnp.maximum(c.y, c.z))


def min3(c: V3):
    return jnp.minimum(c.x, jnp.minimum(c.y, c.z))
