"""Camera: position + quaternion orientation, projection ray helpers, DoF.

Counterpart of src/rendering/camera.{c,h} + the proj_dir/proj_slope helpers
in src/math/frustum.h:26-47 and the thin-lens DoF model of
src/rendering/path_tracer.c:1141-1178, 2418-2452.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

from pim.core import rng
from pim.math.sampling import sample_gauss_pixel_filter, sample_ngon, sample_pentagram
from pim.math.vec3 import MILLI, PI, lerp


# --- quaternion helpers (host-side; np) ------------------------------------


def quat_identity() -> np.ndarray:
    return np.array([0.0, 0.0, 0.0, 1.0], np.float32)  # (x, y, z, w)


def quat_mul_dir(q: np.ndarray, d: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    u = np.array([x, y, z], np.float64)
    d = np.asarray(d, np.float64)
    t = 2.0 * np.cross(u, d)
    out = d + w * t + np.cross(u, t)
    return out.astype(np.float32)


def quat_fwd(q):
    return quat_mul_dir(q, np.array([0.0, 0.0, -1.0]))


def quat_up(q):
    return quat_mul_dir(q, np.array([0.0, 1.0, 0.0]))


def quat_right(q):
    return quat_mul_dir(q, np.array([1.0, 0.0, 0.0]))


def mat3_to_quat(c0, c1, c2) -> np.ndarray:
    """Columns (right, up, forward-ish) -> quaternion (x,y,z,w)."""
    m = np.stack([c0, c1, c2], axis=1).astype(np.float64)  # m[:, i] = ci
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w], np.float64)
    return (q / np.linalg.norm(q)).astype(np.float32)


def quat_lookat(forward: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Quaternion looking along `forward` (ref quat_funcs.h quat_lookat:
    internally negates forward because cameras look down -Z)."""
    f = -np.asarray(forward, np.float64)[:3]
    u = np.asarray(up, np.float64)[:3]
    r = np.cross(u, f)
    r = r / np.linalg.norm(r)
    u = np.cross(f, r)
    u = u / np.linalg.norm(u)
    return mat3_to_quat(r, u, f)


# --- camera state ----------------------------------------------------------


@dataclass
class Camera:
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = field(default_factory=quat_identity)
    z_near: float = 0.1
    z_far: float = 500.0
    fov_y: float = 90.0  # degrees

    def reset(self) -> None:
        self.position = np.zeros(3, np.float32)
        self.rotation = quat_identity()

    def basis(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return quat_right(self.rotation), quat_up(self.rotation), quat_fwd(self.rotation)

    def look_at(self, target) -> None:
        rd = np.asarray(target, np.float32) - self.position
        rd = rd / np.linalg.norm(rd)
        self.rotation = quat_lookat(rd, np.array([0.0, 1.0, 0.0]))


@dataclass
class DofInfo:
    """Thin-lens depth of field (ref PtDofInfo, path_tracer.c:1141-1153)."""

    aperture: float = 5.0e-3
    focal_length: float = 6.0
    blade_count: int = 5
    blade_rot: float = float(np.pi / 10.0)
    focal_plane_curvature: float = 0.05
    autofocus: bool = True
    autofocus_speed: float = 3.0


def proj_slope(fov_y_radians: float, aspect: float):
    t = float(np.tan(fov_y_radians * 0.5))
    return (aspect * t, t)


def proj_dir(right, up, fwd, slope, coord):
    """Screen coord [-1,1]^2 [..., 2] -> unit world ray dir (frustum.h:33-47).
    AoS helper for host-side/np use."""
    x = coord[..., 0:1] * slope[0]
    y = coord[..., 1:2] * slope[1]
    d = fwd + right * x + up * y
    return d / jnp.sqrt(jnp.maximum(jnp.sum(d * d, -1, keepdims=True), 1e-24))


class CameraArrays(NamedTuple):
    """Device-side camera basis — traced values so camera motion does not
    recompile the frame step."""

    eye: jnp.ndarray     # [3]
    right: jnp.ndarray   # [3]
    up: jnp.ndarray      # [3]
    fwd: jnp.ndarray     # [3]
    slope: jnp.ndarray   # [2]
    aperture: jnp.ndarray        # scalar
    focal_length: jnp.ndarray    # scalar (autofocus-adapted state)
    focal_curvature: jnp.ndarray  # scalar


def camera_arrays(camera: Camera, dof: DofInfo, width: int, height: int,
                  focal_length=None) -> CameraArrays:
    right, up, fwd = camera.basis()
    slope = proj_slope(float(np.radians(camera.fov_y)), width / height)
    return CameraArrays(
        eye=jnp.asarray(camera.position),
        right=jnp.asarray(right),
        up=jnp.asarray(up),
        fwd=jnp.asarray(fwd),
        slope=jnp.asarray(slope, jnp.float32),
        aperture=jnp.float32(dof.aperture),
        focal_length=(
            jnp.float32(dof.focal_length) if focal_length is None
            else jnp.asarray(focal_length, jnp.float32)
        ),
        focal_curvature=jnp.float32(dof.focal_plane_curvature),
    )


def generate_primary_rays(cam: CameraArrays, width: int, height: int,
                          state, blade_count: int = 5,
                          blade_rot: float = float(np.pi / 10.0),
                          enable_dof: bool = True, pixel_ids=None):
    """Per-pixel primary rays with gaussian AA jitter + bokeh DoF (SoA).

    Replicates TraceFn's raygen (path_tracer.c:2539-2548).  `state` is a
    rng.RngState; returns (state, ro V3, rd V3).  `pixel_ids` optionally
    selects a subset/shard of the pixel index space.
    """
    from pim.math.vec3 import V3, normalize as nrm3, where3

    if pixel_ids is None:
        i = jnp.arange(width * height, dtype=jnp.int32)
    else:
        i = pixel_ids.astype(jnp.int32)
    cx = (i % width).astype(jnp.float32)
    cy = (i // width).astype(jnp.float32)

    state, (au, av) = rng.next_f32x2(state)
    aax, aay = sample_gauss_pixel_filter(au, av, 1.0)
    u = (cx + 0.5 + aax) / width
    v = (cy + 0.5 + aay) / height
    sx = (u * 2.0 - 1.0) * cam.slope[0]
    sy = (v * 2.0 - 1.0) * cam.slope[1]

    right = V3(cam.right[0], cam.right[1], cam.right[2])
    up = V3(cam.up[0], cam.up[1], cam.up[2])
    fwd = V3(cam.fwd[0], cam.fwd[1], cam.fwd[2])
    eye = V3(
        jnp.broadcast_to(cam.eye[0], i.shape),
        jnp.broadcast_to(cam.eye[1], i.shape),
        jnp.broadcast_to(cam.eye[2], i.shape),
    )

    rd = nrm3(fwd + right * sx + up * sy)
    ro = eye

    if enable_dof:
        state, side = rng.next_u32(state)
        state, (xu, xv) = rng.next_f32x2(state)
        if blade_count == 666:
            offx, offy = sample_pentagram(xu, xv, side)
        else:
            offx, offy = sample_ngon(xu, xv, side, blade_count, jnp.float32(blade_rot))
        offx = offx * cam.aperture
        offy = offy * cam.aperture
        from pim.math.vec3 import dot as dot3

        t = lerp(
            cam.focal_length / dot3(rd, fwd),
            cam.focal_length,
            cam.focal_curvature,
        )
        focus = ro + rd * t
        aperture_pos = ro + right * offx + up * offy
        ro = aperture_pos
        rd = nrm3(focus - aperture_pos)

    return state, ro, rd
