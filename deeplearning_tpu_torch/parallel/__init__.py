"""Parallel helpers of the port. Only the block quantizers of
``collectives.py`` are in so far; the mesh, sharding and collectives come
with multi-GPU (ROADMAP Queue 1 item 7)."""
