"""Rendering engine: camera, intersection, BSDF, integrator, exposure.

Merge of the reference's layers 8-9 (SURVEY.md §1): there is no host/device
split — raygen, traversal, shading, accumulation, and post all run as one
compiled XLA program on the device.
"""
