"""The trio pipeline through the filter stage (runRufus.sh's front half)."""

from .config import RufusConfig  # noqa: F401
from .driver import RufusPipeline  # noqa: F401
