"""The trio pipeline from reads to FINAL.vcf (runRufus.sh,
Overlap.shorter.sh, RUFUS.interpret and the polish scripts)."""

from .config import RufusConfig  # noqa: F401
from .driver import RufusPipeline  # noqa: F401
