"""Distributed pieces of the port. The mixture-of-experts layer (``moe``)
and the tensor-parallel layers at one rank (``mp_layers``) are ported so
far; collectives, meshes and sharding wait for a later slice (ROADMAP.md)."""
