"""Compact irradiance probes: ambient cube + L1 spherical harmonics.

Analog of the reference's ambient-cube fit from Pt_RayGen rays
(the reference's src/math/ambcube.c:5-32: trace `samples` uniform-sphere
rays from a point, fold each into the running 6-face fit with weight
w = 6/(1+samples)/(1+prevSampleCount)).  Here the per-ray loop becomes one
batched trace + one masked projection, and the same ray batch additionally
projects onto an L1 SH probe (src/math/sh.h) — two compact encodings of
the same field, cross-checked by tests.

Consumers: the `probe_bake`/`probe_report` console commands (progressive
light-probe baking at entity or camera positions, the workflow analog of
the reference's editor ambient probe), checkpoint persistence in
render_system, and AmbCube/SH irradiance evaluation for probe export.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pim.math.sh import AmbCube, ambcube_eval, sh_l1_eval, sh_l1_irradiance
from pim.math.vec3 import V3


class LightProbe(NamedTuple):
    """Running progressive fit state for one probe position."""

    origin: jnp.ndarray     # [3]
    faces: jnp.ndarray      # [6, 3] ambient cube rgb per ±x/±y/±z
    sh: jnp.ndarray         # [4, 3] L1 SH coeffs
    sample_count: jnp.ndarray  # scalar i32: completed bake passes


def probe_new(origin) -> LightProbe:
    return LightProbe(
        origin=jnp.asarray(origin, jnp.float32),
        faces=jnp.zeros((6, 3), jnp.float32),
        sh=jnp.zeros((4, 3), jnp.float32),
        sample_count=jnp.int32(0),
    )


def probe_bake_step(meta, arrays, lights, probe: LightProbe,
                    samples: int = 1024, max_bounces: int = 4) -> LightProbe:
    """One progressive pass: trace `samples` uniform-sphere rays from the
    probe origin and fold them into the running cube/SH fits.

    The ambient-cube fold matches AmbCube_Bake's progressive weighting
    (ambcube.c:23-29): this pass's batch fit is blended into the running
    cube with weight 1/(1+prevPasses); the SH fold uses the same schedule
    (both are plain running means over equal-size passes)."""
    from pim.core import rng
    from pim.math.sampling import sample_unit_sphere
    from pim.math.sh import ambcube_fit, sh_l1_project
    from pim.render.integrator import trace_rays

    state = rng.make_state(
        jnp.arange(samples, dtype=jnp.uint32),
        probe.sample_count.astype(jnp.uint32), seed=0x0A3BC0DE,
    )
    state, (u, v) = rng.next_f32x2(state)
    rd = sample_unit_sphere(u, v)
    ro = V3.splat(probe.origin, (samples,))
    res = trace_rays(meta, arrays, lights, ro, rd, state, max_bounces)

    dirs = rd.aos()                      # [S, 3]
    radiance = res.color                 # [S, 3]
    batch_cube = ambcube_fit(dirs, radiance).faces
    batch_sh = sh_l1_project(dirs, radiance)

    w = 1.0 / (1.0 + probe.sample_count.astype(jnp.float32))
    return probe._replace(
        faces=probe.faces + (batch_cube - probe.faces) * w,
        sh=probe.sh + (batch_sh - probe.sh) * w,
        sample_count=probe.sample_count + 1,
    )


def probe_irradiance(probe: LightProbe, normals) -> jnp.ndarray:
    """Cosine-weighted irradiance estimate along [..., 3] normals from the
    ambient cube (ref AmbCube_Irradiance, ambcube.h)."""
    return ambcube_eval(AmbCube(faces=probe.faces), jnp.asarray(normals))


def probe_sh_irradiance(probe: LightProbe, normals) -> jnp.ndarray:
    """The same estimate from the L1 SH fit (cosine-convolved bands)."""
    return sh_l1_irradiance(probe.sh, jnp.asarray(normals))


def probe_radiance(probe: LightProbe, dirs) -> jnp.ndarray:
    """Raw L1 radiance reconstruction along [..., 3] directions."""
    return sh_l1_eval(probe.sh, jnp.asarray(dirs))


def probe_to_crate_entry(probe: LightProbe) -> dict:
    return {
        "origin": np.asarray(probe.origin, np.float32),
        "faces": np.asarray(probe.faces, np.float32),
        "sh": np.asarray(probe.sh, np.float32),
        "sample_count": np.asarray(probe.sample_count, np.int32),
    }


def probe_from_crate_entry(entry: dict) -> LightProbe:
    return LightProbe(
        origin=jnp.asarray(entry["origin"]),
        faces=jnp.asarray(entry["faces"]),
        sh=jnp.asarray(entry["sh"]),
        sample_count=jnp.asarray(entry["sample_count"], jnp.int32),
    )
