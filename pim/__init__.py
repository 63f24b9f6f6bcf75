"""pim — a differentiable wavefront path-tracing framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of Vethanis/pim
(reference: a C11 CPU/Embree progressive path tracer; see SURVEY.md):

- wavefront progressive path tracer (GGX/Burley principled BSDF, NEE+MIS,
  adaptive light-distribution grid, refraction, heterogeneous media)
- physically-based sky (Rayleigh/Mie), histogram auto-exposure, GT tonemap
- progressive spherical-gaussian lightmap baking
- cvar/command/console framework shell, profiler, checkpointing
- differentiable w.r.t. materials / sun / camera; SPMD-sharded over device meshes

Design stance (reference: SURVEY.md §7): arrays + SPMD instead of
pointer-soup + atomics.  Scene is flat SoA tensors, the bounce loop is a
`lax.scan` over masked ray batches, RNG is counter-based per-ray, atomics
become scatter-adds, and the thread pool becomes `shard_map` over a Mesh.
"""

__version__ = "0.1.0"
