"""The trio pipeline through contig alignment (runRufus.sh and
Overlap.shorter.sh up to RUFUS.interpret's inputs)."""

from .config import RufusConfig  # noqa: F401
from .driver import RufusPipeline  # noqa: F401
