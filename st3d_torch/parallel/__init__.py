"""Data and tile parallelism on ``torch.distributed`` (counterpart of
``st3d/parallel``): one process per rank, where the JAX package runs one
process over several devices. ``sharding.py`` holds the world, the view
shards and the data-parallel step; ``tiles.py`` the row-banded render."""
