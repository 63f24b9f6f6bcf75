"""SPMD scale-out: device meshes, pixel-DP sharding, gradient collectives.

Replacement for the reference's thread-pool parallelism
(SURVEY.md §2.9): rays/pixels/texels shard over the mesh's 'dp' axis, the
scene (BVH + textures) is replicated, light-histogram and gradient
reductions are psums over the mesh (NCCL between cards).
"""
