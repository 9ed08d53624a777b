"""Distributed pieces of the port. Only the mixture-of-experts layer is
ported so far (``moe``); collectives, meshes and sharding wait for a later
slice (ROADMAP.md)."""
