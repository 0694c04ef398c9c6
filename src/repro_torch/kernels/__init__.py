"""Controller-datapath kernels: hand-written Hopper kernels and their twins.

``ref`` holds the plain twins (the reference's pure-jnp oracles);
``fused_packed_vote`` is the packed vote's one-call driver."""
from . import ref
from .fused import fused_packed_vote
from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops_all

__all__ = [*_ops_all, "fused_packed_vote", "ref"]
