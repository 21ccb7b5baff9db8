"""Graph layer: ggml's expression-DAG API with source-to-source autodiff."""

from .core import (
    Graph,
    GTensor,
    build_backward,
    build_forward,
    get_f32_1d,
    leaf,
    set_data,
    set_f32,
    set_param,
)
from . import builders

__all__ = [
    "Graph",
    "GTensor",
    "build_backward",
    "build_forward",
    "builders",
    "get_f32_1d",
    "leaf",
    "set_data",
    "set_f32",
    "set_param",
]
