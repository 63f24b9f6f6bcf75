"""The one place that maps the JAX platform to a code path.

  "gpu"  -> the per-ray BVH traversal kernel (render/bvh_kernel.py), for
            every scene size;
  "cpu"  -> the XLA intersectors the tests use: dense brute force up to
            `brute_threshold` triangles, the lockstep BVH loop above it;
  other  -> an error that names the platform.  There is no fallback: a
            path that quietly ran somewhere else would hide the device.
"""

from __future__ import annotations

import jax


def platform() -> str:
    p = jax.default_backend()
    if p not in ("gpu", "cpu"):
        raise RuntimeError(
            f"no code path for JAX platform {p!r}: this renderer runs on "
            "'gpu' (traversal kernel) or 'cpu' (XLA reference paths)")
    return p


def intersect_backend(tri_count: int, brute_threshold: int = 4096) -> str:
    """Intersector for build_scene(backend='auto')."""
    if platform() == "gpu":
        return "kernel"
    return "brute" if tri_count <= brute_threshold else "bvh"


def pallas_interpret() -> bool:
    """Pallas kernels run compiled on the GPU and in the interpreter on the
    CPU, which is how the CPU tests reach them."""
    return platform() == "cpu"
