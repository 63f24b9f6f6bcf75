import jax.numpy as jnp
import numpy as np

from pim.core import rng
from pim.math.vec3 import V3
from pim.render import media


def test_media_defaults_near_vacuum():
    """The reference defaults (40km mfp) are near-vacuum at room scale —
    transmittance over 10m must be ~1."""
    desc = media.make_media_desc()
    n = 256
    state = rng.make_state(jnp.arange(n), 0)
    ro = V3.zeros((n,))
    rd = V3(jnp.ones(n), jnp.zeros(n), jnp.zeros(n))
    state, tr = media.calc_transmittance(desc, state, ro, rd, jnp.full(n, 10.0))
    t = np.asarray(tr.aos())
    # ratio tracking is an unbiased estimator: individual lanes may carry
    # 0.75 null-collision factors; the mean must match exp(-mu*t) ~ 0.9998
    assert t.mean() > 0.99
    assert (t > 0.5).all()


def test_dense_media_attenuates():
    desc = media.make_media_desc(constant_mfp=2.0, absorption=0.5)
    n = 512
    state = rng.make_state(jnp.arange(n), 1)
    ro = V3.zeros((n,))
    rd = V3(jnp.ones(n), jnp.zeros(n), jnp.zeros(n))
    state, tr = media.calc_transmittance(desc, state, ro, rd, jnp.full(n, 5.0))
    t = np.asarray(tr.aos())
    mean_tr = t.mean()
    # Beer-Lambert-ish: mu_t ~ (1/ (2*[0.5..2])) * 1.5 per channel -> clearly < 1
    assert 0.0 < mean_tr < 0.8


def test_scatter_ray_in_dense_media():
    desc = media.make_media_desc(constant_mfp=1.0)
    n = 1024
    state = rng.make_state(jnp.arange(n), 2)
    ro = V3.zeros((n,))
    rd = V3(jnp.ones(n), jnp.zeros(n), jnp.zeros(n))
    state, ms = media.scatter_ray(desc, state, ro, rd, jnp.full(n, 50.0))
    scattered = np.asarray(ms.scattered)
    assert scattered.mean() > 0.5  # dense medium scatters most rays
    # scattered rays moved off the origin along +x
    px = np.asarray(ms.pos.x)
    assert (px[scattered] > 0).all()
    # directions still unit-length
    d = np.asarray(ms.dir.aos())
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-3)


def test_phase_blend():
    desc = media.make_media_desc(phase_dir_a=0.5, phase_dir_b=-0.5, phase_blend=0.5)
    ct = jnp.asarray([1.0, 0.0, -1.0], jnp.float32)
    ph = np.asarray(media.calc_phase(desc, ct))
    assert np.isfinite(ph).all() and (ph > 0).all()
    # symmetric blend of opposite lobes -> forward ≈ backward
    np.testing.assert_allclose(ph[0], ph[2], rtol=1e-3)


# ---------------------------------------------------------------------------
# Radiance cross-check: brute estimator vs the full integrator
# (media previously had no independent radiance contract).
# ---------------------------------------------------------------------------


def _trace_brute_media(meta, arrays, desc, ro, rd, state, vertices):
    """Brute media arbiter: emission collected at EVERY surface vertex
    with weight 1, no NEE, no MIS — a different estimator family from
    trace_rays (in-media NEE + deterministic surface full-MIS), same
    transport.  Shares scatter_ray/BSDF/intersect with the framework, so
    it arbitrates the media ESTIMATOR structure specifically (the same
    role tests/oracle trace_brute plays for the surface estimator)."""
    import jax.numpy as jnp

    from pim.math.brdf import BrdfLut
    from pim.math.vec3 import EPS, RCP_EPS, avg_lum3, saturate, where3
    from pim.render.bsdf import scatter_principled
    from pim.render.scene import scene_intersect
    from pim.render.surface import (
        fetch_hit_attribs,
        get_emission_from_attribs,
        get_surface,
    )

    n = ro.x.shape[0]
    lum = V3.zeros((n,))
    atten = V3.ones((n,))
    alive = jnp.ones((n,), bool)
    lut = BrdfLut(texels=arrays.brdf_lut)

    for _b in range(vertices):
        state, u_rr = rng.next_f32(state)
        p = saturate(avg_lum3(atten))
        survive = u_rr < p
        scale = jnp.where(alive & survive, 1.0 / jnp.maximum(p, EPS), 1.0)
        atten = atten * scale
        alive = alive & survive

        t_far = jnp.where(alive, RCP_EPS, 0.0)
        hit = scene_intersect(meta, arrays, ro, rd, 0.0, t_far)
        missed = hit.tri < 0
        ray_len = jnp.where(missed, RCP_EPS, hit.t)

        state, ms = media.scatter_ray(desc, state, ro, rd, ray_len)
        scattered = alive & ms.scattered
        inv_mpdf = 1.0 / jnp.maximum(ms.pdf, EPS)
        atten = where3(
            scattered, atten * ms.attenuation * inv_mpdf,
            where3(alive, atten * ms.attenuation, atten))

        surf_alive = alive & ~scattered & ~missed & ~hit.backface
        at = fetch_hit_attribs(meta, arrays, hit)
        emission = get_emission_from_attribs(meta, arrays, rd, at)
        lum = lum + emission * atten * surf_alive.astype(jnp.float32)

        surf = get_surface(meta, arrays, ro, rd, hit, attribs=at)
        state, scat = scatter_principled(lut, surf, rd, state)
        cont = surf_alive & (scat.pdf > EPS)
        inv_pdf = 1.0 / jnp.maximum(scat.pdf, EPS)
        atten = where3(cont, atten * scat.attenuation * inv_pdf, atten)

        ro = where3(scattered, ms.pos, where3(cont, scat.pos, ro))
        rd = where3(scattered, ms.dir, where3(cont, scat.dir, rd))
        alive = cont | scattered
    return lum


import pytest  # noqa: E402


@pytest.mark.slow
def test_media_brute_vs_framework():
    """Cross-check the media transport between two estimator families
    (ref ScatterRay/EvaluateLight path_tracer.c:2146-2304, 1921-1942):
    a two-sample z-test on image means over independent chunks, the same
    machinery as tests/test_parity.py."""
    import jax
    import numpy as np

    from pim.geom.cornell import build_cornell_box
    from pim.render.integrator import trace_rays
    from pim.render.scene import build_scene
    from tests.oracle.pt_oracle import pinhole_rays

    ents, pool = build_cornell_box("boxes")
    # make the whole ceiling a (modest) emitter: a brute random walk must
    # actually REACH a light to score, and the default 1 m^2 panel in a
    # 10 m box gives it almost no chance inside the vertex budget (the
    # integrator's in-media NEE scores instantly) — a big soft emitter
    # equalizes the truncation behavior the z-test assumes
    from pim.geom.material import Material

    for i in range(ents.count):
        if ents.names[i] == "Cornell_Ceil":
            m = ents.materials[i]
            ents.materials[i] = Material(
                albedo_tex=m.albedo_tex,
                rome_tex=pool.add_flat((0.9, 1.0, 0.0, 0.1)),
                flags=m.flags, ior=m.ior)
    ents.touch()
    meta, arrays, lights = build_scene(ents, pool, media_enabled=True)
    # room-scale scattering medium: mfp ~15m in a 10m box, some absorption
    desc = media.make_media_desc(constant_mfp=15.0, noise_mfp=1e9,
                                 absorption=0.2)

    w = h = 16
    bounces = 8
    ro_np, rd_np = pinhole_rays(w, h, (-4, 0, 4), (4, -1, -4), (0, 1, 0), 60)
    n = w * h
    ro = V3(*(jnp.asarray(ro_np[:, i], jnp.float32) for i in range(3)))
    rd = V3(*(jnp.asarray(rd_np[:, i], jnp.float32) for i in range(3)))

    @jax.jit
    def fw_sample(s, seed):
        state = rng.make_state(jnp.arange(n, dtype=jnp.uint32), s, seed=seed)
        res = trace_rays(meta, arrays, lights, ro, rd, state, bounces,
                         media_desc=desc)
        return res.color

    @jax.jit
    def br_sample(s, seed):
        state = rng.make_state(jnp.arange(n, dtype=jnp.uint32), s, seed=seed)
        # vertices > bounces + 1: in-media scatter events consume brute
        # iterations without scoring (the integrator's in-media NEE scores
        # at the scatter vertex itself), so the brute gets extra depth;
        # RR + absorption make the >B+1 tail negligible for both
        return _trace_brute_media(meta, arrays, desc, ro, rd, state,
                                  bounces + 4).aos()

    chunks, spp = 4, 64

    def render(fn, seed0):
        means = []
        for c in range(chunks):
            acc = np.zeros((n, 3))
            for s in range(spp):
                acc += np.asarray(fn(jnp.uint32(s), jnp.uint32(seed0 + c)))
            means.append((acc / spp).mean())
        return np.asarray(means)

    fw = render(fw_sample, 40)
    br = render(br_sample, 80)
    fw_m, fw_se = fw.mean(), fw.std(ddof=1) / np.sqrt(chunks)
    br_m, br_se = br.mean(), br.std(ddof=1) / np.sqrt(chunks)
    z = (fw_m - br_m) / np.sqrt(fw_se**2 + br_se**2 + 1e-20)
    rel = fw_m / br_m - 1.0
    print(f"[media] fw={fw_m:.5f}+-{fw_se:.5f} brute={br_m:.5f}+-{br_se:.5f} "
          f"z={z:+.2f} rel={rel:+.4f}")
    assert abs(z) < 4.0, (fw_m, fw_se, br_m, br_se, z)
