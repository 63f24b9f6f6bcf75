"""The platform rule, the compile-cache rule, the bench's refusal of
non-GPU devices, and the XLA fetch/sampling paths that replaced the
one-hot gather kernels."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pim.math.vec3 import V2, V3
from pim.render import fetch as F
from pim.render import platform


@pytest.mark.parametrize("backend, tris, want", [
    ("gpu", 108, "kernel"), ("gpu", 81552, "kernel"),
    ("cpu", 108, "brute"), ("cpu", 81552, "bvh"),
])
def test_platform_rule_picks_the_path(monkeypatch, backend, tris, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert platform.intersect_backend(tris) == want
    assert platform.pallas_interpret() == (backend == "cpu")


def test_platform_rule_refuses_other_platforms(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="'metal'"):
        platform.intersect_backend(108)
    from pim.geom.cornell import build_cornell_box
    from pim.render.scene import build_scene

    ents, pool = build_cornell_box("boxes")
    with pytest.raises(RuntimeError, match="no code path"):
        build_scene(ents, pool, backend="auto")


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    from pim.core import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    saved = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)


def test_compile_cache_defaults_to_checkout_dir(monkeypatch):
    from pim.core import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.cache_dir() == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_bench_refuses_a_non_gpu_device(capsys):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import bench
    finally:
        sys.path.remove(root)
    with pytest.raises(SystemExit, match="no GPU"):
        bench.main()
    assert "cornell512" not in capsys.readouterr().out


@pytest.mark.parametrize("rows", [108, 5000])
def test_fetch_cols_is_exact(rows):
    """Both fetch paths (one-hot product at HIGHEST precision below
    ONEHOT_MAX_ROWS, gather above) return the stored bits."""
    rng = np.random.default_rng(rows)
    table = rng.standard_normal((48, rows)).astype(np.float32)
    table[0, :] *= 1e30
    table[1, :] = rng.uniform(-1e-30, 1e-30, rows)
    idx = rng.integers(0, rows, 4096).astype(np.int32)
    got = np.asarray(jax.jit(F.fetch_cols)(jnp.asarray(table), jnp.asarray(idx)))
    np.testing.assert_array_equal(got.view(np.uint32),
                                  table[:, idx].view(np.uint32))


@pytest.mark.parametrize("rows", [108, 5000])
def test_fetch_cols_out_of_range_gives_zero_columns(rows):
    table = np.arange(48 * rows, dtype=np.float32).reshape(48, rows) + 1.0
    idx = np.asarray([-1, 0, rows - 1, rows, rows + 7, -rows], np.int32)
    got = np.asarray(F.fetch_cols(jnp.asarray(table), jnp.asarray(idx)))
    np.testing.assert_array_equal(got[:, 1], table[:, 0])
    np.testing.assert_array_equal(got[:, 2], table[:, rows - 1])
    for j in (0, 3, 4, 5):
        assert (got[:, j] == 0.0).all()


def test_atlas_bilinear_matches_numpy():
    """surface.sample_atlas_bilinear_multi (the XLA corner gathers) against
    a per-lane numpy bilinear-wrap sampler with the reference's clamped
    corners (sampler.h:176-249), including a 1x1 flat and negative uvs."""
    from pim.render.surface import sample_atlas_bilinear_multi

    rng = np.random.default_rng(4)
    atlas = rng.uniform(0, 1, (16, 32, 4)).astype(np.float32)
    recs = np.asarray([[0, 0, 8, 8], [8, 0, 1, 1], [9, 0, 5, 3],
                       [0, 8, 32, 8]], np.int64)
    planes = atlas.reshape(-1, 4).T
    rec_t = np.zeros((5, 4), np.float32)
    rec_t[:4] = recs.T
    rec_t[4] = atlas.shape[1]
    n = 400
    tex = rng.integers(-1, 4, n).astype(np.int32)
    uv = rng.uniform(-2.0, 2.0, (n, 2)).astype(np.float32)
    out = sample_atlas_bilinear_multi(
        jnp.asarray(planes), jnp.asarray(rec_t),
        [(jnp.asarray(tex), V2(jnp.asarray(uv[:, 0]), jnp.asarray(uv[:, 1])),
          (0.25, 0.5, 0.75, 1.0))])[0]
    got = np.stack([np.asarray(c) for c in out], axis=1)

    def wrap(u):
        u = u if u >= 0 else 1.0 - u
        return u - np.floor(u)

    for i in range(n):
        if tex[i] < 0:
            np.testing.assert_array_equal(got[i], [0.25, 0.5, 0.75, 1.0])
            continue
        x0, y0, w, h = recs[tex[i]]
        fx = np.float32(wrap(uv[i, 0])) * np.float32(max(w - 1, 0))
        fy = np.float32(wrap(uv[i, 1])) * np.float32(max(h - 1, 0))
        ax, ay = int(np.floor(fx)), int(np.floor(fy))
        tx, ty = fx - ax, fy - ay
        bx, by = min(ax + 1, w - 1), min(ay + 1, h - 1)
        c = [atlas[y0 + yy, x0 + xx] for yy, xx in ((ay, ax), (ay, bx),
                                                     (by, ax), (by, bx))]
        top = c[0] + (c[1] - c[0]) * tx
        bot = c[2] + (c[3] - c[2]) * tx
        np.testing.assert_allclose(got[i], top + (bot - top) * ty, rtol=1e-5,
                                   atol=1e-6)


def test_sky_cubemap_soa_matches_numpy_bilinear():
    """sky.sample_sky_cubemap_soa (per-channel XLA gathers) against an
    independent numpy bilinear-clamp fetch of the same face/uv mapping."""
    from pim.render.sky import _RIGHTS, _UPS, sample_sky_cubemap_soa

    rng = np.random.default_rng(12)
    s = 6
    cube = rng.uniform(0, 5, (6, s, s, 3)).astype(np.float32)
    d = rng.standard_normal((300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    out = sample_sky_cubemap_soa(jnp.asarray(cube), V3.from_aos(jnp.asarray(d)))
    got = np.stack([np.asarray(out.x), np.asarray(out.y), np.asarray(out.z)], 1)
    for i, v in enumerate(d):
        a = np.abs(v)
        if a[0] == a.max():
            face = 1 if v[0] < 0 else 0
        elif a[1] == a.max():
            face = 3 if v[1] < 0 else 2
        else:
            face = 5 if v[2] < 0 else 4
        ma = 0.5 / a.max()
        u = np.dot(_RIGHTS[face], v) * ma + 0.5
        w = np.dot(_UPS[face], v) * ma + 0.5
        fx = np.clip(u, 0, 1) * (s - 1)
        fy = np.clip(w, 0, 1) * (s - 1)
        x0, y0 = int(np.floor(fx)), int(np.floor(fy))
        x1, y1 = min(x0 + 1, s - 1), min(y0 + 1, s - 1)
        tx, ty = fx - x0, fy - y0
        top = cube[face, y0, x0] + (cube[face, y0, x1] - cube[face, y0, x0]) * tx
        bot = cube[face, y1, x0] + (cube[face, y1, x1] - cube[face, y1, x0]) * tx
        np.testing.assert_allclose(got[i], top + (bot - top) * ty, rtol=1e-4,
                                   atol=1e-4)
