"""Variant interpretation: contig alignments -> VCF (RUFUS.interpret role).

Host Python and numpy, the JAX package's interpret copied line for line
(its row order is Python's dict and sort order);
tests/test_torch_interpret.py holds it to that package's output."""

from .driver import run_interpret  # noqa: F401
