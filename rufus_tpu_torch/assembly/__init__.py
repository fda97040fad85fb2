"""Greedy overlap assembly (OverlapSam / Overlap / OverlapRegion family):
host Python, the port's own copy of the JAX package's modules."""
