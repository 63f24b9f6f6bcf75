"""Numerical core: vector helpers, sampling, BRDF, color, distributions.

Counterpart of the reference's src/math/ (SURVEY.md §2.3): everything is
pure jnp over [..., k] float32 tensors — no scalar loops, no mutable state.
"""
