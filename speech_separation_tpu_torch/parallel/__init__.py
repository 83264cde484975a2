"""Data parallelism: the mesh of devices (parallel/mesh.py) and the ranks of
a training run over it (parallel/ranks.py)."""
