"""Regenerate the committed framework golden images (tests/goldens/).

Must run on the CPU backend (the tests' backend, see tests/conftest.py).
Regenerate ONLY after tools/parity_debug.py confirms an estimator change
is a fix, not a regression — the golden is the deterministic tripwire of
the parity contract (tests/test_parity.py::test_framework_golden).
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, ".")
sys.path.insert(0, "tests")

from tests.test_parity import _framework_render, _rays
from pim.geom.cornell import build_cornell_box


def main():
    out_dir = os.path.join("tests", "goldens")
    os.makedirs(out_dir, exist_ok=True)
    ents, pool = build_cornell_box("boxes")
    ro, rd = _rays()
    img = _framework_render(ents, pool, ro, rd, spp=64, seed=12345)
    path = os.path.join(out_dir, "cornell_ggx_24_spp64.npy")
    np.save(path, img.astype(np.float32))
    print(f"wrote {path}: mean={img.mean():.6f}")

    # map-class golden: textures + sky + normal maps + glass (the drift
    # tripwire for BASELINE configs #3/#4; test_framework_golden_map)
    from tests.test_parity import _golden_map_scene

    ents, pool, sky, (ro, rd) = _golden_map_scene()
    img = _framework_render(ents, pool, ro, rd, spp=64, seed=12345, sky=sky)
    path = os.path.join(out_dir, "map1room_24_spp64.npy")
    np.save(path, img.astype(np.float32))
    print(f"wrote {path}: mean={img.mean():.6f}")


if __name__ == "__main__":
    main()
