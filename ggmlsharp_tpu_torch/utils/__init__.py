"""Observability tooling (port of ggmlsharp_tpu/utils: graph_print,
graph_dump_dot, print_objects)."""

from .debug import graph_print, print_objects
from .graphviz import graph_dump_dot

__all__ = ["graph_dump_dot", "graph_print", "print_objects"]
