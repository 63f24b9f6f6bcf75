"""Three-way arbiter for the diffuse-Cornell parity bias.

Renders the 24x24 diffuse Cornell with:
  (a) the framework integrator
  (b) the numpy oracle (NEE + stochastic-MIS transliteration)
  (c) a brute-force estimator (emission at every vertex, no NEE)
All three are unbiased estimators of the same truncated transport; each is
run as K independent chunks so the image-mean carries a standard error.

Usage: python tools/parity_debug.py [spp_per_chunk] [chunks]
"""
import sys
import time

import numpy as np

sys.path.insert(0, ".")
sys.path.insert(0, "tests")

from tests.test_parity import (
    BOUNCES, _framework_render, _override_materials, _rays,
)
from pim.geom.cornell import build_cornell_box
from tests.oracle import pt_oracle as oracle


def chunked(fn, k, tag):
    t0 = time.time()
    means = []
    img = None
    for i in range(k):
        im = fn(i)
        means.append(im.mean())
        img = im if img is None else img + im
    means = np.array(means)
    m = means.mean()
    se = means.std(ddof=1) / np.sqrt(k)
    print(f"{tag:8s} mean={m:.5f} +- {se:.5f}  ({time.time()-t0:.1f}s, "
          f"{k} chunks)")
    return m, se, img / k


def main():
    spp = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 8

    ents, pool = build_cornell_box("boxes")
    _override_materials(ents, pool, roughness=1.0, metallic=0.0)
    ro, rd = _rays()
    scene = oracle.scene_from_entities(ents, pool)

    b, b_se, _ = chunked(
        lambda i: oracle.render(scene, ro, rd, spp=spp * 2,
                                max_bounces=BOUNCES, seed=1000 + i,
                                brute=True),
        k, "brute")
    o, o_se, _ = chunked(
        lambda i: oracle.render(scene, ro, rd, spp=spp,
                                max_bounces=BOUNCES, seed=2000 + i),
        k, "oracle")
    f, f_se, _ = chunked(
        lambda i: _framework_render(ents, pool, ro, rd, spp=spp,
                                    seed=3000 + i),
        k, "framewk")

    def z(a, a_se, c, c_se):
        return (a - c) / np.sqrt(a_se**2 + c_se**2)

    print(f"oracle  vs brute: {(o/b-1)*100:+6.2f}%  z={z(o,o_se,b,b_se):+5.1f}")
    print(f"framewk vs brute: {(f/b-1)*100:+6.2f}%  z={z(f,f_se,b,b_se):+5.1f}")
    print(f"framewk vs oracle:{(f/o-1)*100:+6.2f}%  z={z(f,f_se,o,o_se):+5.1f}")


if __name__ == "__main__":
    main()
