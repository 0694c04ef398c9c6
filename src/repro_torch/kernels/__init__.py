"""Controller-datapath kernels: hand-written Hopper kernels and their twins."""
from .ops import *  # noqa: F401,F403
from .ops import __all__  # noqa: F401
