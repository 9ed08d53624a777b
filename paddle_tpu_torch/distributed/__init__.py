"""Distributed pieces of the port. The mixture-of-experts layer (``moe``),
the tensor-parallel layers at one rank (``mp_layers``) and the recommender's
embedding table in its single-shard form (``embedding``) are ported so far;
collectives, meshes and sharding wait for a later slice (ROADMAP.md)."""
