"""Render system: the per-frame orchestrator + console commands.

Counterpart of src/rendering/render_system.c — owns the progressive trace
buffers, the scene, the camera/DoF, and exposure; registers the engine's
console commands (cornell_box, pt_test, pt_stddev, screenshot, teleport,
lookat, mapload/mapsave...).  The whole frame — raygen, trace, accumulate,
light-grid adapt, autofocus probe, auto-exposure — is ONE jitted XLA program
per (scene, resolution); camera motion and sample index are traced inputs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
import functools
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from pim.core import cvars as cv
from pim.core import rng
from pim.core.cmd import CmdStat, cmd_getopt, get_cmd_system
from pim.core.console import LogSev, con_logf
from pim.core.crate import Crate
from pim.core.profiler import profile
from pim.core.timesys import get_timesys
from pim.geom.cornell import build_cornell_box
from pim.geom.entities import Entities
from pim.geom.material import TexturePool
from pim.math.vec3 import RCP_EPS
from pim.render.camera import Camera, CameraArrays, DofInfo, camera_arrays, generate_primary_rays
from pim.render.exposure import (
    ExposureParams,
    ExposureState,
    exposure_pass,
    make_exposure_state,
)
from pim.render.integrator import (
    TraceBuffers,
    TraceResult,
    accumulate,
    luminance_stddev,
    make_trace_buffers,
    trace_rays,
)
from pim.render.scene import (
    LightState,
    build_scene,
    scene_intersect,
    update_light_state,
)
from pim.render.screenshot import quantize_dithered, tonemap_for_display, write_png


def _load_gate_band(sample_count: int, scene: str = "cornell",
                    aspect: float = 1.0):
    """Calibrated pt_gate band for a given accumulated sample count.

    pt_gate_bands.json (committed next to this module; regenerated by
    tools/calibrate_pt_gate.py from N seeded runs per tier) holds entries
    {min_samples, maxstddev, meanlo, meanhi, scene[, aspect]} sorted by
    min_samples; the tightest tier of the matching scene not exceeding
    sample_count applies.  An entry with an `aspect` (width / height)
    applies only to frames of that aspect: the wider 16:9 view of a map
    sees other surfaces than a square one, so its mean differs.  Returns
    (maxstddev, meanlo, meanhi) or None when no tier covers the count."""
    import json

    path = os.path.join(os.path.dirname(__file__), "pt_gate_bands.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        data = json.load(f)
    best = None
    for e in data.get("entries", []):
        if e.get("scene", "cornell") != scene:
            continue
        if "aspect" in e and abs(e["aspect"] - aspect) > 0.01:
            continue
        if e["min_samples"] <= sample_count:
            if best is None or e["min_samples"] > best["min_samples"]:
                best = e
    if best is None:
        return None
    return (float(best["maxstddev"]), float(best["meanlo"]),
            float(best["meanhi"]))


@functools.lru_cache(maxsize=8)
def _make_frame_step(meta, width: int, height: int, max_bounces: int,
                     blade_count: int, blade_rot: float, autofocus_rate: float,
                     debug: bool = False, spp: int = 1):
    """Build the jitted progressive-frame function for a fixed scene+res.

    lru_cached on the full static config (SceneMeta is a frozen
    dataclass): a fresh RenderSystem with an identical scene shape —
    checkpoint resume, repeated tests — reuses the jitted step and its
    XLA executable instead of recompiling (~5s/compile on CPU CI).

    spp (cvar pt_spp) batches that many independent 1-spp samples inside
    one compiled step — sample_idx..sample_idx+spp-1 streams, their exact
    mean folded with weight spp/count (identical to spp sequential EMA
    folds).  Amortizes per-dispatch host latency.

    debug=True (cvar pt_debug) wraps the step in checkify user-checks that
    assert the progressive state stays finite — the sanitizer analog of the
    reference's ASSERT density (SURVEY §5; src/threading/task.c:73-74): a
    NaN texel / degenerate triangle / zero-area light must either shade
    cleanly or fail LOUDLY, never silently poison the accumulators."""

    def _impl(arrays, lights: LightState, buffers: TraceBuffers,
             exp_state: ExposureState, exp_params: ExposureParams,
             cam: CameraArrays, sample_idx, sample_weight, dt, autofocus,
             seed):
        n = width * height

        # autofocus probe (ref DofUpdate :2485-2503): one ray down the view
        from pim.math.vec3 import V3

        probe = scene_intersect(
            meta, arrays,
            V3(cam.eye[0:1], cam.eye[1:2], cam.eye[2:3]),
            V3(cam.fwd[0:1], cam.fwd[1:2], cam.fwd[2:3]),
            0.0, RCP_EPS,
        )
        t_af = jnp.clip(1.0 - jnp.exp(-dt * autofocus_rate), 0.0, 1.0)
        focal = jnp.where(
            autofocus & (probe.t[0] > 0.0),
            cam.focal_length + (probe.t[0] - cam.focal_length) * t_af,
            cam.focal_length,
        )
        cam = cam._replace(focal_length=focal)

        def one_sample(i, carry):
            acc_color, acc_albedo, acc_normal, live, rays = carry
            state = rng.make_state(
                jnp.arange(n, dtype=jnp.uint32),
                sample_idx.astype(jnp.uint32) + i, seed=seed,
            )
            state, ro, rd = generate_primary_rays(
                cam, width, height, state, blade_count, blade_rot
            )
            res = trace_rays(meta, arrays, lights, ro, rd, state, max_bounces)
            return (acc_color + res.color, acc_albedo + res.albedo,
                    acc_normal + res.normal, live + res.live,
                    rays + res.rays_traced)

        z = jnp.zeros((n, 3), jnp.float32)
        g, e_live = lights.live.shape
        acc_color, acc_albedo, acc_normal, live_delta, rays_traced = (
            jax.lax.fori_loop(
                0, spp, one_sample,
                (z, z, z, jnp.zeros((g, e_live), jnp.uint32),
                 jnp.float32(0.0))))
        inv = jnp.float32(1.0 / spp)
        batch = TraceResult(
            color=acc_color * inv, albedo=acc_albedo * inv,
            normal=acc_normal * inv, live=live_delta,
            rays_traced=rays_traced,
        )
        buffers = accumulate(buffers, batch, sample_weight)

        # fold the frame's light-histogram delta, then adapt (ref UpdateDists)
        lights = lights._replace(live=lights.live + live_delta)
        lights = update_light_state(lights)

        exp_state = exposure_pass(buffers.color, exp_params, exp_state, dt)

        if debug:
            from jax.experimental import checkify

            checkify.check(
                jnp.all(jnp.isfinite(buffers.color)),
                "pt_debug: non-finite radiance in the accumulated color "
                "buffer (sample {s})", s=sample_idx)
            checkify.check(
                jnp.all(jnp.isfinite(lights.pdf)),
                "pt_debug: non-finite adapted light pdf (sample {s})",
                s=sample_idx)
            checkify.check(
                jnp.isfinite(exp_state.avg_lum) & jnp.isfinite(focal),
                "pt_debug: non-finite exposure/autofocus state (sample {s})",
                s=sample_idx)
        return buffers, lights, exp_state, focal

    if not debug:
        return jax.jit(_impl)

    from jax.experimental import checkify

    checked = jax.jit(checkify.checkify(_impl, errors=checkify.user_checks))

    def step(*args):
        err, out = checked(*args)
        checkify.check_error(err)  # raises on the first poisoned sample
        return out

    return step


@dataclass
class RenderSystem:
    width: int = 256
    height: int = 256
    max_bounces: int = 10

    entities: Entities = field(default_factory=Entities)
    pool: TexturePool = field(default_factory=TexturePool)
    camera: Camera = field(default_factory=Camera)
    dof: DofInfo = field(default_factory=DofInfo)

    meta: object = None
    arrays: object = None
    lights: Optional[LightState] = None
    buffers: Optional[TraceBuffers] = None
    exp_state: ExposureState = field(default_factory=make_exposure_state)
    sample_count: int = 0
    scene_modtime: int = -1
    lm_pack: object = None
    probes: dict = field(default_factory=dict)  # name -> LightProbe
    _lm_frame: int = 0
    _step = None
    _cam_snapshot: tuple = ()
    _sky_versions: dict = field(default_factory=dict)
    _cfg_versions: dict = field(default_factory=dict)
    _refl_version: int = -1

    def init(self) -> None:
        self._register_cmds()

    # --- scene management ---------------------------------------------------

    def _ensure_scene(self) -> None:
        if self.meta is None or self.entities.modtime != self.scene_modtime:
            with profile("PtScene_Update"):
                backend = cv.cv_pt_backend.get()
                self.meta, self.arrays, self.lights = build_scene(
                    self.entities, self.pool, backend=backend,
                    media_enabled=cv.cv_pt_media.get(),
                )
                self.scene_modtime = self.entities.modtime
                self._step = None
                self.reset_accumulation()

    def reset_accumulation(self) -> None:
        self.buffers = make_trace_buffers(self.width, self.height)
        self.sample_count = 0

    def set_resolution(self, width: int, height: int) -> None:
        if (width, height) != (self.width, self.height):
            self.width = width
            self.height = height
            self._step = None
            self.reset_accumulation()

    def _camera_snapshot(self):
        return (
            tuple(np.round(self.camera.position, 6).tolist()),
            tuple(np.round(self.camera.rotation, 6).tolist()),
            round(self.camera.fov_y, 4),
        )

    # --- per-frame ----------------------------------------------------------

    def _check_dirty(self, *cvars) -> bool:
        """ConVar_CheckDirty over a set (ref render_system.c:429-466)."""
        dirty = False
        for c in cvars:
            d, v = c.check_dirty(self._cfg_versions.get(c.name, -1))
            self._cfg_versions[c.name] = v
            dirty = dirty or d
        return dirty

    def _check_config(self) -> None:
        """Honor runtime cvar changes that the compiled step/scene bake in
        (a frozen cvar is a config lie).  First call just
        records versions; later changes invalidate the right layer."""
        first = not self._cfg_versions
        res_dirty = self._check_dirty(cv.cv_r_width, cv.cv_r_height,
                                      cv.cv_r_scale)
        scene_dirty = self._check_dirty(cv.cv_pt_backend, cv.cv_pt_media,
                                        cv.cv_r_brdflut_spf)
        step_dirty = self._check_dirty(cv.cv_pt_max_bounces, cv.cv_pt_debug,
                                       cv.cv_pt_spp)
        accum_dirty = self._check_dirty(cv.cv_pt_seed)
        if first:
            return
        if res_dirty:
            s = float(cv.cv_r_scale.get())
            self.set_resolution(
                max(1, int(round(cv.cv_r_width.get() * s))),
                max(1, int(round(cv.cv_r_height.get() * s))))
        if scene_dirty:
            self.scene_modtime = -1  # full PtScene rebuild next frame
        elif step_dirty:
            self._step = None
            self.reset_accumulation()
        elif accum_dirty:
            # seed is a traced input (no recompile), but mixing streams
            # mid-accumulation breaks run reproducibility — restart
            self.reset_accumulation()

    def update(self) -> None:
        """One progressive frame (ref RenderSys_Update + PathTrace)."""
        if not cv.cv_pt_trace.get():
            return
        self._check_config()
        self._ensure_scene()
        if self.meta.tri_count == 0:
            return

        snap = self._camera_snapshot()
        if snap != self._cam_snapshot:
            self._cam_snapshot = snap
            self.reset_accumulation()

        self._bake_sky()
        self._lightmap_trace()
        self._cubemap_trace()

        if self._step is None:
            self._step = _make_frame_step(
                self.meta, self.width, self.height,
                max_bounces=cv.cv_pt_max_bounces.get(),
                blade_count=self.dof.blade_count,
                blade_rot=self.dof.blade_rot,
                autofocus_rate=self.dof.autofocus_speed,
                debug=bool(cv.cv_pt_debug.get()),
                spp=max(int(cv.cv_pt_spp.get()), 1),
            )

        ts = get_timesys()
        dt = jnp.float32(max(ts.smooth_delta, 1.0 / 240.0))
        spp = max(int(cv.cv_pt_spp.get()), 1)
        base_idx = self.sample_count
        self.sample_count += spp
        # folding a batch MEAN of spp samples with weight spp/new_count is
        # exactly spp sequential 1/n EMA folds (both equal the running mean)
        sw = jnp.float32(spp / self.sample_count)
        cam = camera_arrays(
            self.camera, self.dof, self.width, self.height,
            focal_length=self.dof.focal_length,
        )
        with profile("Pt_Trace"):
            self.buffers, self.lights, self.exp_state, focal = self._step(
                self.arrays, self.lights, self.buffers,
                self.exp_state, ExposureParams.from_cvars(), cam,
                jnp.uint32(base_idx), sw, dt,
                jnp.asarray(self.dof.autofocus),
                jnp.uint32(cv.cv_pt_seed.get()),
            )
        self.dof.focal_length = float(focal)

    # --- progressive bakes (ref RenderSys_Update :181-245,427-494) ----------

    def _bake_sky(self) -> None:
        """Dirty-checked sky cubemap rebake (ref BakeSky :427-494): when any
        sun/atmosphere cvar changes and the scene has a sky material, rebake
        ``arrays.sky`` and restart accumulation."""
        if not getattr(self.meta, "has_sky", False):
            return
        watched = (cv.cv_r_sun_dir, cv.cv_r_sun_lum, cv.cv_r_sun_res,
                   cv.cv_r_sun_steps, cv.cv_sky_rad_cr, cv.cv_sky_rad_at,
                   cv.cv_sky_rlh_mfp, cv.cv_sky_rlh_sh, cv.cv_sky_mie_mfp,
                   cv.cv_sky_mie_sh, cv.cv_sky_mie_g)
        dirty = False
        for c in watched:
            d, v = c.check_dirty(self._sky_versions.get(c.name, -1))
            self._sky_versions[c.name] = v
            dirty = dirty or d
        if not dirty:
            return
        from pim.render.sky import atmosphere_from_cvars, bake_sky_cubemap

        with profile("BakeSky"):
            sd = np.asarray(cv.cv_r_sun_dir.get()[:3], np.float32)
            sd = sd / max(np.linalg.norm(sd), 1e-6)
            cube = bake_sky_cubemap(
                atmosphere_from_cvars(), sd, float(cv.cv_r_sun_lum.get()),
                int(cv.cv_r_sun_res.get()), int(cv.cv_r_sun_steps.get()))
            self.arrays = self.arrays._replace(sky=cube)
        self.reset_accumulation()

    def _lightmap_trace(self) -> None:
        """Progressive SG lightmap bake while lm_gen=1 (ref Lightmap_Trace
        :181-213): pack once, then one timesliced bake_step per frame."""
        if not cv.cv_lm_gen.get():
            return
        from pim.geom.entities import flatten
        from pim.render import lightmap as lm

        if self.lm_pack is None:
            flat = flatten(self.entities)
            self.lm_pack = lm.pack_lightmaps(
                flat.positions, flat.normals,
                texels_per_meter=float(cv.cv_lm_density.get()))
            self._lm_frame = 0
            if self.lm_pack is None:
                return
        with profile("Lightmap_Trace"):
            slices = max(int(cv.cv_lm_timeslice.get()), 1)
            t_total = self.lm_pack.position.shape[1]
            shard = -(-t_total // slices)
            off = (self._lm_frame % slices) * shard
            count = min(shard, t_total - off)
            if count > 0:
                spp = max(int(cv.cv_lm_spp.get()), 1)
                # distinct sample counter per spp pass: bake_step seeds its
                # rng from (texel_id, frame), so reusing one frame value
                # would fold identical rays spp times (ADVICE r1)
                for k in range(spp):
                    self.lm_pack = lm.bake_step(
                        self.meta, self.arrays, self.lights, self.lm_pack,
                        self._lm_frame * spp + k,
                        max_bounces=cv.cv_pt_max_bounces.get(),
                        texel_offset=off, texel_count=count)
            self._lm_frame += 1

    def _cubemap_trace(self) -> None:
        """Progressive reflection-probe bake while r_refl_gen=1 (ref
        Cubemap_Trace :216-245): bake+convolve every registered probe.

        Probes bake from their own bounds center (ref box_center(bounds),
        render_system.c:235-239), NOT the camera — the camera is only the
        fallback origin for unbounded probes, frozen at first bake.  The
        per-probe sample count resets when r_refl_gen goes dirty."""
        d, v = cv.cv_r_refl_gen.check_dirty(self._refl_version)
        self._refl_version = v
        from pim.render.cubemap import get_registry

        reg = get_registry()
        if d:
            reg.reset_samples()
        if not cv.cv_r_refl_gen.get():
            return
        if not reg.names():
            reg.add("default", 64)
        with profile("Cubemap_Trace"):
            for name in reg.names():
                reg.bake(name, self.meta, self.arrays, self.lights,
                         fallback_origin=np.asarray(self.camera.position, np.float32),
                         max_bounces=cv.cv_pt_max_bounces.get())

    # --- checkpoint / resume --------------------------------------------
    # The reference persists the whole progressive state via Crate: entities
    # (drawable.h:49-61), the lightmap pack INCLUDING per-texel sample
    # counts (lightmap.c:1225+, DiskLmPack lightmap.h:45-53).  Here the
    # checkpoint additionally carries the trace buffers, sample count,
    # adaptive light state and exposure, so a killed progressive render
    # resumes bit-identically.

    def checkpoint_save(self, path: str) -> None:
        crate = Crate()
        crate.set("entities", self.entities.to_crate_entry())
        crate.set("textures", self.pool.to_crate_entry())
        crate.set("camera", {
            "position": np.asarray(self.camera.position, np.float32),
            "rotation": np.asarray(self.camera.rotation, np.float32),
            "fov_y": float(self.camera.fov_y),
            "z_near": float(self.camera.z_near),
            "z_far": float(self.camera.z_far),
        })
        crate.set("dof", {
            "aperture": float(self.dof.aperture),
            "focal_length": float(self.dof.focal_length),
            "blade_count": int(self.dof.blade_count),
            "blade_rot": float(self.dof.blade_rot),
            "focal_plane_curvature": float(self.dof.focal_plane_curvature),
            "autofocus": bool(self.dof.autofocus),
            "autofocus_speed": float(self.dof.autofocus_speed),
        })
        crate.set("progress", {
            "width": self.width, "height": self.height,
            "sample_count": self.sample_count,
            "lm_frame": self._lm_frame,
        })
        if self.buffers is not None:
            crate.set("buffers", {
                "color": np.asarray(self.buffers.color),
                "albedo": np.asarray(self.buffers.albedo),
                "normal": np.asarray(self.buffers.normal),
            })
        if self.lights is not None:
            crate.set("lights", {
                f: np.asarray(getattr(self.lights, f))
                for f in LightState._fields
            })
        crate.set("exposure", {
            "avg_lum": float(self.exp_state.avg_lum),
            "exposure": float(self.exp_state.exposure),
        })
        if self.lm_pack is not None:
            crate.set("lmpack", {
                "size": int(self.lm_pack.size),
                "texels_per_meter": float(self.lm_pack.texels_per_meter),
                "position": np.asarray(self.lm_pack.position),
                "normal": np.asarray(self.lm_pack.normal),
                "probes": np.asarray(self.lm_pack.probes),
                "sample_counts": np.asarray(self.lm_pack.sample_counts),
            })
        if self.probes:
            from pim.render.probes import probe_to_crate_entry

            crate.set("light_probes", {
                name: probe_to_crate_entry(p)
                for name, p in self.probes.items()
            })
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        crate.save(path)

    def checkpoint_load(self, path: str) -> None:
        crate = Crate.load(path)
        self.entities = Entities.from_crate_entry(crate.get("entities"))
        tex = crate.get("textures")
        self.pool = (TexturePool.from_crate_entry(tex)
                     if tex is not None else TexturePool())
        c = crate.get("camera")
        self.camera.position = np.asarray(c["position"], np.float32)
        self.camera.rotation = np.asarray(c["rotation"], np.float32)
        self.camera.fov_y = float(c["fov_y"])
        self.camera.z_near = float(c["z_near"])
        self.camera.z_far = float(c["z_far"])
        d = crate.get("dof")
        for k, v in d.items():
            setattr(self.dof, k, type(getattr(self.dof, k))(v))
        prog = crate.get("progress")
        self.set_resolution(int(prog["width"]), int(prog["height"]))
        # rebuild the derived scene (meta/arrays/BVH) from the restored
        # entities, then overwrite the adaptive light state with the
        # checkpointed one (it has learned histograms a rebuild would lose)
        self._ensure_scene()
        lt = crate.get("lights")
        if lt is not None:
            self.lights = LightState(**{
                f: jnp.asarray(lt[f]) for f in LightState._fields
            })
        buf = crate.get("buffers")
        if buf is not None:
            self.buffers = TraceBuffers(
                color=jnp.asarray(buf["color"]),
                albedo=jnp.asarray(buf["albedo"]),
                normal=jnp.asarray(buf["normal"]),
            )
        self.sample_count = int(prog["sample_count"])
        self._lm_frame = int(prog["lm_frame"])
        e = crate.get("exposure")
        self.exp_state = ExposureState(
            avg_lum=jnp.float32(e["avg_lum"]),
            exposure=jnp.float32(e["exposure"]),
        )
        lp = crate.get("lmpack")
        if lp is not None:
            from pim.render.lightmap import LmPack

            self.lm_pack = LmPack(
                size=int(lp["size"]),
                texels_per_meter=float(lp["texels_per_meter"]),
                position=jnp.asarray(lp["position"]),
                normal=jnp.asarray(lp["normal"]),
                probes=jnp.asarray(lp["probes"]),
                sample_counts=jnp.asarray(lp["sample_counts"]),
            )
        pr = crate.get("light_probes")
        if pr is not None:
            from pim.render.probes import probe_from_crate_entry

            self.probes = {
                name: probe_from_crate_entry(e) for name, e in pr.items()
            }
        # restored camera must not retrigger an accumulation reset
        self._cam_snapshot = self._camera_snapshot()

    # --- outputs ------------------------------------------------------------

    def image_hdr(self, denoised: Optional[bool] = None) -> np.ndarray:
        """The accumulated HDR buffer; denoised when pt_denoise is on
        (ref PathTrace denoise branch, render_system.c:311-330)."""
        color = self.buffers.color
        if denoised is None:
            denoised = bool(cv.cv_pt_denoise.get())
        if denoised:
            from pim.render.denoise import DenoiseType, denoise

            color = denoise(
                DenoiseType.Image, self.width, self.height, color,
                albedo=self.buffers.albedo, normal=self.buffers.normal,
            )
        return np.asarray(color).reshape(self.height, self.width, 3)

    def stddev(self) -> float:
        return float(luminance_stddev(self.buffers.color))

    def screenshot(self, name: Optional[str] = None) -> str:
        """Tonemapped PNG (ref CmdScreenshot :680-745)."""
        import time as _time

        if name is None:
            name = _time.strftime("%Y_%m_%d_%H_%M_%S")
        path = os.path.join("screenshots", f"{name}.png")
        hdr = jnp.asarray(self.image_hdr())
        srgb = tonemap_for_display(hdr, self.exp_state.exposure)
        rgb8 = quantize_dithered(srgb)
        write_png(path, rgb8, flip_vertical=True)
        con_logf(LogSev.Info, "Sc", "Took screenshot '%s'", path)
        return path

    # --- commands (ref RenderSys_Init :500-513) ------------------------------

    def _register_cmds(self) -> None:
        sys = get_cmd_system()

        def cmd_cornell(argv: List[str]) -> CmdStat:
            prim = argv[1] if len(argv) > 1 else "boxes"
            self.entities, self.pool = build_cornell_box(prim)
            self.camera.reset()
            self.reset_accumulation()
            return CmdStat.OK

        def cmd_teleport(argv: List[str]) -> CmdStat:
            if len(argv) < 4:
                con_logf(LogSev.Error, "cmd", "usage: teleport x y z")
                return CmdStat.ERR
            self.camera.position = np.asarray(
                [float(argv[1]), float(argv[2]), float(argv[3])], np.float32
            )
            return CmdStat.OK

        def cmd_lookat(argv: List[str]) -> CmdStat:
            if len(argv) < 4:
                con_logf(LogSev.Error, "cmd", "usage: lookat x y z")
                return CmdStat.ERR
            self.camera.look_at([float(argv[1]), float(argv[2]), float(argv[3])])
            return CmdStat.OK

        def cmd_pt_test(argv: List[str]) -> CmdStat:
            frames = cmd_getopt(argv, "frames")
            frames = int(frames) if frames else 500
            frames = max(1, min(frames, 1 << 23))
            q = get_cmd_system()
            q.enqueue("cornell_box")
            q.enqueue("teleport -4 0 4")
            q.enqueue("lookat 0 -1 0")
            q.enqueue("pt_denoise 0")
            q.enqueue("exp_manual 1")
            q.enqueue("exp_evoffset 5")
            q.enqueue("pt_trace 1")
            q.enqueue(f"wait {frames}")
            q.enqueue("pt_stddev")
            # regression gate: calibrated bands (pt_gate_bands.json, from
            # tools/calibrate_pt_gate.py) unless explicit bounds / -nogate
            # are passed through (ADVICE r3).  A run is NEVER silently
            # ungated: bare pt_gate errors when no band covers it.
            if cmd_getopt(argv, "nogate", flag=True):
                pass
            else:
                fwd = ""
                for opt in ("maxstddev", "meanlo", "meanhi"):
                    val = cmd_getopt(argv, opt)
                    if val is not None:
                        fwd += f" -{opt} {val}"
                q.enqueue("pt_gate" + fwd)
            # ref pt_test (:1362-1371): denoised + raw screenshot pair
            q.enqueue("pt_denoise 1")
            q.enqueue("screenshot")
            q.enqueue("pt_denoise 0")
            q.enqueue("screenshot; pt_trace 0")
            q.enqueue("quit")
            return CmdStat.OK

        def cmd_pt_gate(argv: List[str]) -> CmdStat:
            """Convergence regression gate (ref pt_test only
            *prints* the stddev, render_system.c:1374-1410 — here it is
            asserted).  Fails (-> nonzero batch exit via app.py) when the
            accumulated image's luminance stddev exceeds -maxstddev or its
            mean leaves [-meanlo, -meanhi].

            With no explicit bounds, the band comes from the committed
            calibration (pt_gate_bands.json: N seeded runs per sample-count
            tier, tools/calibrate_pt_gate.py).  No covering band = ERR —
            the gate never silently passes."""
            if self.buffers is None:
                con_logf(LogSev.Error, "pt", "pt_gate: nothing rendered")
                return CmdStat.ERR
            max_sd_s = cmd_getopt(argv, "maxstddev")
            mean_lo_s = cmd_getopt(argv, "meanlo")
            mean_hi_s = cmd_getopt(argv, "meanhi")
            if max_sd_s is None and mean_lo_s is None and mean_hi_s is None:
                scene = cmd_getopt(argv, "scene") or "cornell"
                band = _load_gate_band(self.sample_count, scene,
                                       self.width / self.height)
                if band is None:
                    con_logf(
                        LogSev.Error, "pt",
                        "pt_gate: no calibrated '%s' band covers %d samples "
                        "(regenerate with tools/calibrate_pt_gate.py or "
                        "pass -maxstddev/-meanlo/-meanhi)",
                        scene, self.sample_count)
                    return CmdStat.ERR
                max_sd, mean_lo, mean_hi = band
            else:
                max_sd = float(max_sd_s or "1e30")
                mean_lo = float(mean_lo_s or "0")
                mean_hi = float(mean_hi_s or "1e30")
            sd = self.stddev()
            mean = float(np.asarray(self.buffers.color).mean())
            ok = (sd <= max_sd) and (mean_lo <= mean <= mean_hi)
            con_logf(
                LogSev.Info if ok else LogSev.Error, "pt",
                "pt_gate %s: stddev=%f (max %g) mean=%f (band [%g, %g]) "
                "@ %d samples",
                "OK" if ok else "FAIL", sd, max_sd, mean, mean_lo, mean_hi,
                self.sample_count)
            return CmdStat.OK if ok else CmdStat.ERR

        def cmd_pt_stddev(argv: List[str]) -> CmdStat:
            if self.buffers is None:
                return CmdStat.ERR
            sd = self.stddev()
            con_logf(LogSev.Info, "pt", "StdDev: %f", sd)
            self.screenshot(f"pt_stddev_{sd:f}")
            return CmdStat.OK

        def cmd_screenshot(argv: List[str]) -> CmdStat:
            if self.buffers is None:
                con_logf(LogSev.Error, "Sc", "nothing rendered yet")
                return CmdStat.ERR
            self.screenshot(argv[1] if len(argv) > 1 else None)
            return CmdStat.OK

        def cmd_mapsave(argv: List[str]) -> CmdStat:
            name = argv[1] if len(argv) > 1 else "map"
            crate = Crate()
            crate.set("entities", self.entities.to_crate_entry())
            # textures ride with the map: material records hold atlas ids,
            # which dangle in a fresh session without the pool (ref
            # render_system.c:1493-1502 stores textures in the map crate)
            crate.set("textures", self.pool.to_crate_entry())
            os.makedirs("maps", exist_ok=True)
            crate.save(os.path.join("maps", f"{name}.crate"))
            con_logf(LogSev.Info, "map", "saved maps/%s.crate", name)
            return CmdStat.OK

        def cmd_mapload(argv: List[str]) -> CmdStat:
            if len(argv) < 2:
                con_logf(LogSev.Error, "cmd", "usage: mapload <name>")
                return CmdStat.ERR
            name = argv[1]
            path = os.path.join("maps", f"{name}.crate")
            if os.path.exists(path):
                crate = Crate.load(path)
                self.entities = Entities.from_crate_entry(crate.get("entities"))
                tex = crate.get("textures")
                self.pool = (TexturePool.from_crate_entry(tex)
                             if tex is not None else TexturePool())
                self.camera.reset()
                self.reset_accumulation()
                return CmdStat.OK
            # glTF fallback (ref: data/<name>/glTF/<name>.gltf)
            from pim.geom.gltf import load_gltf_scene

            gltf_path = os.path.join(
                cv.cv_basedir.get(), name, "glTF", f"{name}.gltf"
            )
            try:
                self.entities, self.pool = load_gltf_scene(gltf_path)
            except FileNotFoundError:
                con_logf(LogSev.Error, "map", "no map '%s'", name)
                return CmdStat.ERR
            self.camera.reset()
            self.reset_accumulation()
            return CmdStat.OK

        def cmd_mapgen(argv: List[str]) -> CmdStat:
            """Generate a procedural multi-room map, export it as a real glTF
            asset under <basedir>/<name>/glTF/, then load it through the
            importer (full mapload pipeline, ref render_system.c:1417-1464)."""
            name = argv[1] if len(argv) > 1 else "e1m1"
            rooms_s = cmd_getopt(argv, "rooms")
            seed_s = cmd_getopt(argv, "seed")
            steps_s = cmd_getopt(argv, "steps")
            rooms = tuple(int(v) for v in rooms_s.split("x")) if rooms_s else (3, 3)
            from pim.geom.maps import export_map

            path = export_map(
                name, base_dir=cv.cv_basedir.get(),
                rooms=rooms, seed=int(seed_s) if seed_s else 1,
                sphere_steps=int(steps_s) if steps_s else 24,
            )
            con_logf(LogSev.Info, "map", "generated %s", path)
            return get_cmd_system().immediate(f"mapload {name}")

        def cmd_ckpt_save(argv: List[str]) -> CmdStat:
            name = argv[1] if len(argv) > 1 else "ckpt"
            path = os.path.join("maps", f"{name}.ckpt.crate")
            self.checkpoint_save(path)
            con_logf(LogSev.Info, "ckpt", "saved %s (sample %d)", path,
                     self.sample_count)
            return CmdStat.OK

        def cmd_ckpt_load(argv: List[str]) -> CmdStat:
            name = argv[1] if len(argv) > 1 else "ckpt"
            path = os.path.join("maps", f"{name}.ckpt.crate")
            if not os.path.exists(path):
                con_logf(LogSev.Error, "ckpt", "no checkpoint '%s'", path)
                return CmdStat.ERR
            self.checkpoint_load(path)
            con_logf(LogSev.Info, "ckpt", "resumed %s at sample %d", path,
                     self.sample_count)
            return CmdStat.OK

        def cmd_loadtest(argv: List[str]) -> CmdStat:
            """Load/unload every map under <basedir> (ref loadtest, stubbed
            there at render_system.c:1412-1415; functional here).  The
            session's scene is restored afterwards — including on a mid-list
            failure (ADVICE r2: never leave a partial map active)."""
            base = cv.cv_basedir.get()
            if not os.path.isdir(base):
                con_logf(LogSev.Error, "map", "no basedir '%s'", base)
                return CmdStat.ERR
            names = sorted(
                n for n in os.listdir(base)
                if os.path.isdir(os.path.join(base, n, "glTF"))
            )
            saved = (self.entities, self.pool, self.scene_modtime)
            status = CmdStat.OK
            try:
                for n in names:
                    if get_cmd_system().immediate(f"mapload {n}") != CmdStat.OK:
                        status = CmdStat.ERR
                        break
                    tris = sum(
                        m.length // 3
                        for m in self.entities.meshes if m is not None
                    )
                    con_logf(LogSev.Info, "map", "loadtest %s: %d tris ok",
                             n, tris)
            finally:
                self.entities, self.pool, _ = saved
                # force a scene rebuild: the loop replaced meta/arrays
                self.scene_modtime = -1
                self.reset_accumulation()
            if status == CmdStat.OK:
                con_logf(LogSev.Info, "map", "loadtest: %d maps ok",
                         len(names))
            return status

        def cmd_probe_bake(argv: List[str]) -> CmdStat:
            """Progressive ambient-cube + L1-SH light probe at the camera
            (or -at x y z); ref AmbCube_Bake from Pt_RayGen rays,
            ambcube.c:5-32.  Repeat to refine (running-mean passes)."""
            from pim.render.probes import probe_bake_step, probe_new

            self._ensure_scene()
            if self.meta is None or self.meta.tri_count == 0:
                con_logf(LogSev.Error, "probe", "no scene loaded")
                return CmdStat.ERR
            name = argv[1] if len(argv) > 1 and not argv[1].startswith("-") \
                else "camera"
            samples = int(cmd_getopt(argv, "samples") or 1024)
            at = cmd_getopt(argv, "at")
            if at is not None:
                i = argv.index("-at") if "-at" in argv else argv.index("--at")
                origin = np.asarray(
                    [float(argv[i + 1]), float(argv[i + 2]),
                     float(argv[i + 3])], np.float32)
            else:
                origin = np.asarray(self.camera.position, np.float32)
            probe = self.probes.get(name)
            if probe is None or not np.allclose(np.asarray(probe.origin),
                                                origin):
                probe = probe_new(origin)
            probe = probe_bake_step(
                self.meta, self.arrays, self.lights, probe,
                samples=samples, max_bounces=cv.cv_pt_max_bounces.get())
            self.probes[name] = probe
            con_logf(LogSev.Info, "probe",
                     "probe '%s' pass %d (%d rays) at (%.2f %.2f %.2f)",
                     name, int(probe.sample_count), samples,
                     *origin.tolist())
            return CmdStat.OK

        def cmd_probe_report(argv: List[str]) -> CmdStat:
            """Log a probe's ambient-cube faces and SH irradiance along the
            six axes (the observability analog of the exposure readouts)."""
            from pim.render.probes import (
                probe_irradiance, probe_sh_irradiance,
            )

            name = argv[1] if len(argv) > 1 else "camera"
            probe = self.probes.get(name)
            if probe is None:
                con_logf(LogSev.Error, "probe", "no probe '%s'", name)
                return CmdStat.ERR
            axes = np.asarray([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                               [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.float32)
            cube = np.asarray(probe_irradiance(probe, axes))
            sh = np.asarray(probe_sh_irradiance(probe, axes))
            tags = ["+x", "-x", "+y", "-y", "+z", "-z"]
            for i, tag in enumerate(tags):
                con_logf(LogSev.Info, "probe",
                         "%s %s cube(%.4f %.4f %.4f) sh(%.4f %.4f %.4f)",
                         name, tag, *cube[i].tolist(), *sh[i].tolist())
            return CmdStat.OK

        sys.reg("probe_bake", cmd_probe_bake,
                "bake an ambient-cube/SH light probe")
        sys.reg("probe_report", cmd_probe_report,
                "log a light probe's irradiance")
        sys.reg("cornell_box", cmd_cornell, "load the cornell box test scene")
        sys.reg("mapgen", cmd_mapgen, "generate + export + load a procedural map")
        sys.reg("loadtest", cmd_loadtest, "load/unload every map in basedir")
        sys.reg("teleport", cmd_teleport, "move the camera")
        sys.reg("lookat", cmd_lookat, "aim the camera at a point")
        sys.reg("pt_test", cmd_pt_test, "run the path tracer convergence test")
        sys.reg("pt_gate", cmd_pt_gate, "assert stddev/mean bounds (regression gate)")
        sys.reg("pt_stddev", cmd_pt_stddev, "print luminance stddev + screenshot")
        sys.reg("screenshot", cmd_screenshot, "write a tonemapped png")
        sys.reg("mapsave", cmd_mapsave, "save entities + textures to a crate")
        sys.reg("mapload", cmd_mapload, "load a map (crate or glTF)")
        sys.reg("ckpt_save", cmd_ckpt_save, "checkpoint the full progressive state")
        sys.reg("ckpt_load", cmd_ckpt_load, "resume from a progressive checkpoint")
