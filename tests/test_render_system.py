"""RenderSystem orchestrator tests: progressive frames, checkpoint/resume,
map round-trips with textures, cvar dirty-checking, and the pt_gate
regression command (ref shapes: render_system.c:1348-1502).
"""

import os

import numpy as np
import pytest

from pim.core import cvars as cv
from pim.core.cmd import CmdStat, get_cmd_system
from pim.render.render_system import RenderSystem

W = H = 16
BOUNCES = 3


@pytest.fixture()
def rs(tmp_path, monkeypatch):
    """A small render system in a scratch cwd, cvars restored afterwards."""
    monkeypatch.chdir(tmp_path)
    saved = [
        (c, c.get())
        for c in (cv.cv_pt_trace, cv.cv_pt_max_bounces, cv.cv_r_width,
                  cv.cv_r_height, cv.cv_r_scale, cv.cv_pt_backend,
                  cv.cv_exp_manual)
    ]
    cv.cv_pt_max_bounces.set(BOUNCES)
    cv.cv_pt_trace.set(True)
    cv.cv_exp_manual.set(True)
    sys = RenderSystem(width=W, height=H)
    sys.init()
    get_cmd_system().immediate("cornell_box")
    sys.camera.position = np.asarray([-4.0, 0.0, 4.0], np.float32)
    sys.camera.look_at([0.0, -1.0, 0.0])
    sys.dof.autofocus = False
    yield sys
    for c, v in saved:
        c.set(v)


def _frames(rs, k):
    for _ in range(k):
        rs.update()


def test_progressive_frames_accumulate(rs):
    _frames(rs, 2)
    assert rs.sample_count == 2
    img = np.asarray(rs.buffers.color)
    assert np.isfinite(img).all()
    assert img.mean() > 0.0


def test_checkpoint_resume_bit_identical(rs):
    """Kill-and-resume continuation must match an uninterrupted run exactly
    (ref resumable bake state, lightmap.c:1225+)."""
    _frames(rs, 2)
    rs.checkpoint_save("maps/t.ckpt.crate")
    _frames(rs, 2)
    ref_img = np.asarray(rs.buffers.color).copy()
    ref_n = rs.sample_count

    fresh = RenderSystem(width=4, height=4)  # wrong res: ckpt must fix it
    fresh.init()
    fresh.checkpoint_load("maps/t.ckpt.crate")
    assert (fresh.width, fresh.height) == (W, H)
    assert fresh.sample_count == 2
    _frames(fresh, 2)
    assert fresh.sample_count == ref_n
    np.testing.assert_array_equal(np.asarray(fresh.buffers.color), ref_img)


def test_checkpoint_carries_light_state(rs):
    _frames(rs, 2)
    live_before = np.asarray(rs.lights.live).copy()
    rs.checkpoint_save("maps/l.ckpt.crate")
    fresh = RenderSystem()
    fresh.init()
    fresh.checkpoint_load("maps/l.ckpt.crate")
    np.testing.assert_array_equal(np.asarray(fresh.lights.live), live_before)
    np.testing.assert_allclose(
        np.asarray(fresh.lights.pdf), np.asarray(rs.lights.pdf))


def test_mapsave_roundtrips_textures(rs):
    """mapload into a fresh session must not dangle texture ids (the
    reference stores textures in the map crate, render_system.c:1493-1502)."""
    import jax.numpy as jnp

    q = get_cmd_system()
    assert q.immediate("mapsave t1") == CmdStat.OK
    n_tex = len(rs.pool)
    assert n_tex > 0

    fresh = RenderSystem(width=W, height=H)
    fresh.init()
    assert get_cmd_system().immediate("mapload t1") == CmdStat.OK
    assert len(fresh.pool) == n_tex
    for i in range(n_tex):
        np.testing.assert_array_equal(fresh.pool.get(i), rs.pool.get(i))
    # the loaded scene must actually render (ids resolve into the atlas)
    fresh.camera.position = np.asarray([-4.0, 0.0, 4.0], np.float32)
    fresh.camera.look_at([0.0, -1.0, 0.0])
    fresh.dof.autofocus = False
    _frames(fresh, 1)
    assert np.asarray(fresh.buffers.color).mean() > 0.0


def test_cvar_bounce_change_rebuilds_step(rs):
    """pt_max_bounces must take effect without a scene rebuild
    (frozen-cvar config lie; ref ConVar_CheckDirty usage
    render_system.c:429-466)."""
    _frames(rs, 1)
    step_before = rs._step
    assert step_before is not None
    cv.cv_pt_max_bounces.set(1)
    _frames(rs, 1)
    assert rs._step is not step_before
    assert rs.sample_count == 1  # accumulation restarted


def test_cvar_resolution_change_applies(rs):
    _frames(rs, 1)
    cv.cv_r_width.set(8)
    cv.cv_r_height.set(8)
    cv.cv_r_scale.set(1.0)
    _frames(rs, 1)
    assert (rs.width, rs.height) == (8, 8)
    assert np.asarray(rs.buffers.color).shape[0] == 64


def test_pt_gate(rs):
    _frames(rs, 2)
    q = get_cmd_system()
    assert q.immediate("pt_gate -maxstddev 1e9 -meanlo 0 -meanhi 1e9") == CmdStat.OK
    assert q.immediate("pt_gate -maxstddev 1e-9") == CmdStat.ERR
    assert q.immediate("pt_gate -meanlo 1e8 -meanhi 1e9") == CmdStat.ERR
    # deferred failures surface in the batch exit code (app.py contract)
    before = q.error_count
    q.enqueue("pt_gate -maxstddev 1e-9")
    q.update()
    assert q.error_count == before + 1


def test_pt_spp_batching_matches_sequential(rs):
    """pt_spp=2 (one batched step) equals two sequential 1-spp frames:
    identical sample streams, same running mean (float-order tolerance)."""
    _frames(rs, 4)
    seq = np.asarray(rs.buffers.color).copy()
    assert rs.sample_count == 4

    cv.cv_pt_spp.set(2)
    try:
        fresh = RenderSystem(width=W, height=H)
        fresh.init()
        fresh.entities, fresh.pool = rs.entities, rs.pool
        fresh.camera.position = np.asarray(rs.camera.position).copy()
        fresh.camera.rotation = np.asarray(rs.camera.rotation).copy()
        fresh.dof.autofocus = False
        _frames(fresh, 2)
        assert fresh.sample_count == 4
        np.testing.assert_allclose(np.asarray(fresh.buffers.color), seq,
                                   rtol=2e-5, atol=2e-6)
    finally:
        cv.cv_pt_spp.set(1)
