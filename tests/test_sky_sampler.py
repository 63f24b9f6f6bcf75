"""Cross-check the three sky cubemap samplers on an asymmetric cubemap.

Advisor r4 (medium): the oracle's -Y face basis was flipped on both axes
and nothing compared the samplers directly — the textured+sky parity
contract silently sampled one face rotated 180°.  This test makes the
oracle (tests/oracle/pt_oracle.py sample_sky), the AoS framework sampler
(render/sky.py sample_sky_cubemap) and the SoA arithmetic-select sampler
(sample_sky_cubemap_soa) agree on a cubemap whose every texel is unique,
over directions covering all six faces (ref basis: cubemap.h:71-100,
Cubemap_kRights/kUps).
"""

import numpy as np
import jax.numpy as jnp

from pim.math.vec3 import V3
from pim.render.sky import sample_sky_cubemap, sample_sky_cubemap_soa
from tests.oracle import pt_oracle as oracle


def _asym_cube(size=8):
    """[6, S, S, 3] cubemap with globally unique texel values so any
    face/axis flip changes the fetched radiance."""
    rng = np.random.default_rng(7)
    cube = rng.uniform(0.1, 4.0, (6, size, size, 3))
    # make it strongly face- and corner-asymmetric
    for f in range(6):
        cube[f] += f * 10.0
        cube[f, 0, 0] += 100.0
    return cube.astype(np.float32)


def _dirs_all_faces(n_per_face=64):
    """Directions biased into each of the 6 major axes, plus edge cases."""
    rng = np.random.default_rng(11)
    dirs = []
    axes = [
        (0, +1), (0, -1), (1, +1), (1, -1), (2, +1), (2, -1),
    ]
    for ax, sign in axes:
        d = rng.uniform(-0.9, 0.9, (n_per_face, 3))
        d[:, ax] = sign * 1.0
        dirs.append(d)
    # exact axis directions (texel-center / clamp paths)
    for ax, sign in axes:
        d = np.zeros((1, 3))
        d[0, ax] = sign
        dirs.append(d)
    d = np.concatenate(dirs, 0)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_sky_samplers_agree_all_faces():
    cube = _asym_cube()
    dirs = _dirs_all_faces()

    class _S:  # minimal oracle-scene shim: sample_sky only reads .sky
        sky = cube.astype(np.float64)

    want = oracle.sample_sky(_S, dirs.astype(np.float64))

    got_aos = np.asarray(sample_sky_cubemap(jnp.asarray(cube), jnp.asarray(dirs)))
    np.testing.assert_allclose(got_aos, want, rtol=2e-5, atol=2e-5)

    rd = V3(jnp.asarray(dirs[:, 0]), jnp.asarray(dirs[:, 1]), jnp.asarray(dirs[:, 2]))
    got_soa = sample_sky_cubemap_soa(jnp.asarray(cube), rd)
    got_soa = np.stack([np.asarray(got_soa.x), np.asarray(got_soa.y), np.asarray(got_soa.z)], -1)
    np.testing.assert_allclose(got_soa, want, rtol=2e-5, atol=2e-5)


def test_sky_sampler_minus_y_face_orientation():
    """Pin the -Y face basis specifically (the advisor's finding): a
    direction tilted +x,+z from straight down must read the texel the
    reference basis (right=[-1,0,0], up=[0,0,-1]) selects — u decreases
    with +x, v decreases with +z."""
    size = 8
    cube = np.zeros((6, size, size, 3), np.float32)
    # face 3 (-Y): value = u*1 + v*100 at texel centers
    uu, vv = np.meshgrid(np.arange(size), np.arange(size), indexing="xy")
    cube[3, :, :, 0] = uu + 100.0 * vv

    d = np.array([[0.4, -1.0, 0.6]], np.float32)
    d /= np.linalg.norm(d)
    got = np.asarray(sample_sky_cubemap(jnp.asarray(cube), jnp.asarray(d)))[0, 0]

    # reference math: ma=0.5/|y|, u = -x*ma+0.5, v = -z*ma+0.5
    ma = 0.5 / abs(d[0, 1])
    u = -d[0, 0] * ma + 0.5
    v = -d[0, 2] * ma + 0.5
    fx, fy = u * (size - 1), v * (size - 1)
    x0, y0 = int(np.floor(fx)), int(np.floor(fy))
    tx, ty = fx - x0, fy - y0
    c = cube[3, :, :, 0]
    want = (
        c[y0, x0] * (1 - tx) * (1 - ty)
        + c[y0, min(x0 + 1, size - 1)] * tx * (1 - ty)
        + c[min(y0 + 1, size - 1), x0] * (1 - tx) * ty
        + c[min(y0 + 1, size - 1), min(x0 + 1, size - 1)] * tx * ty
    )
    np.testing.assert_allclose(got, want, rtol=1e-5)
