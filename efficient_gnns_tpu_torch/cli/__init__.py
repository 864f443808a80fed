"""CLI entry points of the port (one per workload, as in the JAX package)."""
