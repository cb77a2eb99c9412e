"""GraSorw in PyTorch + CUDA: the port of the JAX package ``repro``.

It keeps the JAX package's module layout — core (graph, buckets,
scheduling, loading, stats), io (walk pools, block store, block files),
engines (the bi-block engine and the pair advance), kernels (hand-written
CUDA for Hopper beside their plain PyTorch versions), launch — and imports
torch and numpy only.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
