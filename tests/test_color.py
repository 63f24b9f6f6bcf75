"""Color science parity vs the reference constants (color.h / color_gen.h).

The matrices are spec constants copied from the autogenerated tables
(the reference's src/math/color_gen.h:100-180); the tests verify (a) each
pair round-trips, (b) the matrices agree with values derived from the
primaries' chromaticities, (c) the PQ/HLG transfer functions invert and
hit their anchor points from Rec.2100 / ST.2084.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pim.math import color as C


def _rand_rgb(n=256, seed=3):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.uniform(0.0, 4.0, (n, 3)).astype(np.float32))


@pytest.mark.parametrize(
    "fwd,inv",
    [
        (C.rec709_to_rec2020, C.rec2020_to_rec709),
        (C.rec709_to_ap0, C.ap0_to_rec709),
        (C.rec709_to_ap1, C.ap1_to_rec709),
        (C.rec2020_to_ap0, C.ap0_to_rec2020),
        (C.rec2020_to_ap1, C.ap1_to_rec2020),
    ],
)
def test_space_round_trips(fwd, inv):
    c = _rand_rgb()
    np.testing.assert_allclose(np.asarray(inv(fwd(c))), np.asarray(c),
                               rtol=2e-5, atol=2e-5)


def _primaries_matrix(prim, white):
    """RGB->XYZ from chromaticities (the generator behind color_gen.h)."""
    def xyz(xy):
        x, y = xy
        return np.array([x / y, 1.0, (1 - x - y) / y])

    m = np.stack([xyz(p) for p in prim], axis=1)
    w = xyz(white)
    s = np.linalg.solve(m, w)
    return m * s


# Rec.709, Rec.2020 (D65) chromaticities
_REC709 = _primaries_matrix(
    [(0.64, 0.33), (0.30, 0.60), (0.15, 0.06)], (0.3127, 0.3290))
_REC2020 = _primaries_matrix(
    [(0.708, 0.292), (0.170, 0.797), (0.131, 0.046)], (0.3127, 0.3290))

# The reference's base matrices (color_gen.h:7-99, rows from the c0/c1/c2
# columns): RGB->XYZ per space plus the D65<->D60 adaptation used for the
# ACES hops.
_REF_REC709_XYZ = np.array(
    [[0.41239077, 0.35758433, 0.18048084],
     [0.21263900, 0.71516865, 0.07219233],
     [0.01933080, 0.11919472, 0.95053232]])
_REF_REC2020_XYZ = np.array(
    [[0.63695812, 0.14461692, 0.16888094],
     [0.26270023, 0.67799807, 0.05930171],
     [0.00000000, 0.02807269, 1.06098485]])
_REF_XYZ_AP0 = np.array(
    [[1.04981089, 0.00000000, -0.00009748],
     [-0.49590302, 1.37331307, 0.09824004],
     [0.00000000, 0.00000000, 0.99125206]])
_REF_XYZ_AP1 = np.array(
    [[1.64102328, -0.32480329, -0.23642468],
     [-0.66366309, 1.61533189, 0.01675636],
     [0.01172196, -0.00828445, 0.98839509]])
_REF_D65_D60 = np.array(
    [[1.02797151, 0.00145030, -0.01282999],
     [0.00077021, 1.02688038, -0.00400242],
     [-0.00286672, 0.00501085, 0.95095807]])


def test_rec2020_matrix_matches_primaries():
    """709->2020 shares the D65 white — the direct primaries-derived hop
    must reproduce the committed constants."""
    derived = np.linalg.solve(_REC2020, _REC709)
    np.testing.assert_allclose(np.asarray(C.M_REC709_TO_REC2020), derived,
                               atol=2.5e-4)


@pytest.mark.parametrize(
    "mat,rgb_xyz,xyz_ap",
    [
        (C.M_REC709_TO_AP0, _REF_REC709_XYZ, _REF_XYZ_AP0),
        (C.M_REC709_TO_AP1, _REF_REC709_XYZ, _REF_XYZ_AP1),
        (C.M_REC2020_TO_AP0, _REF_REC2020_XYZ, _REF_XYZ_AP0),
        (C.M_REC2020_TO_AP1, _REF_REC2020_XYZ, _REF_XYZ_AP1),
    ],
)
def test_ap_matrices_are_reference_composites(mat, rgb_xyz, xyz_ap):
    """Committed ACES constants == XYZ_AP @ D65_D60 @ RGB_XYZ, the
    reference generator's pipeline (RGB -> XYZ(D65) -> adapt D60 -> AP)."""
    np.testing.assert_allclose(np.asarray(mat),
                               xyz_ap @ _REF_D65_D60 @ rgb_xyz, atol=1e-6)


def test_pq_eotf_inverts():
    sig = jnp.linspace(0.0, 1.0, 64)
    lum = C.pq_eotf(sig)
    back = C.pq_inverse_eotf(lum)
    np.testing.assert_allclose(np.asarray(back), np.asarray(sig), atol=2e-4)


def test_pq_anchor_points():
    # ST.2084: signal 1.0 == 10000 cd/m²; 0 == 0
    np.testing.assert_allclose(float(C.pq_eotf(jnp.float32(1.0))), 10000.0,
                               rtol=1e-4)
    assert float(C.pq_eotf(jnp.float32(0.0))) == 0.0
    np.testing.assert_allclose(float(C.pq_inverse_eotf(jnp.float32(10000.0))),
                               1.0, rtol=1e-4)


def test_pq_oetf_fit_tracks_exact():
    # the reference ships a rational fit (color.h f4_PQ_OETF_Fit) for the
    # hot path; measured against the exact OETF it stays within ~0.05
    # signal over scene range [0.01, 1] (it is a coarse fit by design)
    e = jnp.linspace(0.01, 1.0, 128)
    np.testing.assert_allclose(np.asarray(C.pq_oetf_fit(e)),
                               np.asarray(C.pq_oetf(e)), atol=0.055)
    # and is monotonic
    f = np.asarray(C.pq_oetf_fit(e))
    assert np.all(np.diff(f) > 0)


def test_hlg_anchor_points():
    # Rec.2100 HLG: V(1/12) = 0.5, V(1) = 1
    np.testing.assert_allclose(float(C.hlg_oetf(jnp.float32(1.0 / 12.0))),
                               0.5, atol=1e-6)
    np.testing.assert_allclose(float(C.hlg_oetf(jnp.float32(1.0))), 1.0,
                               atol=1e-6)
    assert float(C.hlg_oetf(jnp.float32(0.0))) == 0.0


def test_hlg_ootf_gamma_at_1000_nits():
    # at P=1000 the system gamma is 1.2; a flat white scene value maps to
    # P * Ys^0.2 * S
    s = jnp.ones((1, 3)) * 0.5
    d = C.hlg_ootf(s, 1000.0)
    ys = 0.5  # luminance of flat 0.5
    expect = 1000.0 * ys ** 0.2 * 0.5
    np.testing.assert_allclose(np.asarray(d)[0], expect, rtol=1e-5)


def test_fitted_gt_tonemap_tracks_exact():
    """The cubic_fit TMap rational (screenshot r_tonemap_fit path) tracks
    the exact GT operator within display precision (measured max ~0.021)."""
    from pim.math.cubic_fit import tmap_eval
    from pim.render.screenshot import fitted_gt_coeffs

    coeffs = fitted_gt_coeffs(1.0)
    xs = jnp.linspace(0.0, 4.0, 512)
    fit = np.clip(np.asarray(tmap_eval(xs, coeffs)), 0.0, 1.0)
    exact = np.asarray(C.gt_tonemap(xs, P=1.0, a=1.0, m=0.5, l=0.4,
                                    c=1.33, b=0.0))
    assert np.abs(fit - exact).max() < 0.03
    # and the display path accepts the switch end-to-end
    from pim.render.screenshot import tonemap_for_display

    img = jnp.ones((4, 4, 3)) * 0.8
    out = np.asarray(tonemap_for_display(img, jnp.float32(1.0),
                                         use_fit=True))
    assert np.all((out >= 0) & (out <= 1)) and np.all(np.isfinite(out))


def test_scene_space_switch():
    c = _rand_rgb(16)
    # default rec709 scene: identity both ways
    np.testing.assert_array_equal(np.asarray(C.color_sdr_to_scene(c)),
                                  np.asarray(c))
    # ap1 scene: sdr->scene->sdr round-trips, scene->hdr == ap1->rec2020
    fwd = C.color_sdr_to_scene(c, "ap1")
    back = C.color_scene_to_sdr(fwd, "ap1")
    np.testing.assert_allclose(np.asarray(back), np.asarray(c), atol=2e-5)
    np.testing.assert_allclose(
        np.asarray(C.color_scene_to_hdr(fwd, "ap1")),
        np.asarray(C.ap1_to_rec2020(fwd)), atol=1e-7)
