"""L1 spherical harmonics and ambient cubes.

Counterpart of src/math/sh.h and src/math/ambcube.{c,h}: compact radiance
probes fit from uniformly sampled rays (the Pt_RayGen consumer).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from pim.math.vec import PI

# L1 SH basis constants
_Y0 = 0.282094791  # 1/(2 sqrt(pi))
_Y1 = 0.488602512  # sqrt(3)/(2 sqrt(pi))


def sh_l1_basis(dirs):
    """[..., 3] unit dirs -> [..., 4] (Y00, Y1-1, Y10, Y11)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ones = jnp.ones_like(x)
    return jnp.stack([_Y0 * ones, _Y1 * y, _Y1 * z, _Y1 * x], axis=-1)


def sh_l1_project(dirs, radiance):
    """Monte-Carlo project radiance samples onto L1 SH.

    dirs [S, 3], radiance [S, 3] -> coeffs [4, 3] (uniform sphere pdf)."""
    basis = sh_l1_basis(dirs)  # [S, 4]
    s = dirs.shape[0]
    return jnp.einsum("sb,sc->bc", basis, radiance, precision="highest") * (4.0 * PI / s)


def sh_l1_eval(coeffs, dirs):
    """coeffs [4, 3], dirs [..., 3] -> radiance [..., 3]."""
    basis = sh_l1_basis(dirs)
    return jnp.einsum("...b,bc->...c", basis, coeffs, precision="highest")


def sh_l1_irradiance(coeffs, normal):
    """Cosine-convolved irradiance from L1 SH (standard A0=pi, A1=2pi/3)."""
    a0 = PI
    a1 = 2.0 * PI / 3.0
    basis = sh_l1_basis(normal)
    weights = jnp.asarray([a0 * _Y0, a1 * _Y1, a1 * _Y1, a1 * _Y1]) / jnp.asarray(
        [_Y0, _Y1, _Y1, _Y1]
    )
    # simplifies to per-band scale of the basis projection
    scaled = basis * jnp.asarray([a0, a1, a1, a1])
    return jnp.einsum("...b,bc->...c", scaled, coeffs, precision="highest") / PI


class AmbCube(NamedTuple):
    """6-directional ambient cube (ref ambcube.h): rgb per ±x, ±y, ±z."""

    faces: jnp.ndarray  # [6, 3]


def ambcube_fit(dirs, radiance) -> AmbCube:
    """Fit an ambient cube from uniform sphere samples (ref ambcube.c:17)."""
    w = jnp.stack(
        [
            jnp.maximum(dirs[..., 0], 0.0),
            jnp.maximum(-dirs[..., 0], 0.0),
            jnp.maximum(dirs[..., 1], 0.0),
            jnp.maximum(-dirs[..., 1], 0.0),
            jnp.maximum(dirs[..., 2], 0.0),
            jnp.maximum(-dirs[..., 2], 0.0),
        ],
        axis=-1,
    )  # [S, 6]
    wsum = jnp.maximum(jnp.sum(w, axis=0), 1e-6)  # [6]
    faces = jnp.einsum("sf,sc->fc", w, radiance, precision="highest") / wsum[:, None]
    return AmbCube(faces=faces)


def ambcube_eval(cube: AmbCube, normal):
    """Irradiance estimate along normal [..., 3] -> [..., 3]."""
    n2 = normal * normal
    pos = normal > 0.0
    x = jnp.where(pos[..., 0:1], cube.faces[0], cube.faces[1])
    y = jnp.where(pos[..., 1:2], cube.faces[2], cube.faces[3])
    z = jnp.where(pos[..., 2:3], cube.faces[4], cube.faces[5])
    return x * n2[..., 0:1] + y * n2[..., 1:2] + z * n2[..., 2:3]
