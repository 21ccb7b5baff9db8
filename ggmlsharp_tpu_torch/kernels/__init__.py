"""Hand-written Hopper kernels of the port, each beside its plain version."""
from ._build import LAUNCHES, build, reset_launches, set_defines

__all__ = ["LAUNCHES", "build", "reset_launches", "set_defines"]
