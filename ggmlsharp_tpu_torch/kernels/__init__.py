"""Hand-written Hopper kernels of the port, each beside its plain version."""
from ._build import LAUNCHES, build, reset_launches

__all__ = ["LAUNCHES", "build", "reset_launches"]
