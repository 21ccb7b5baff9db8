"""Observability tooling (port of ggmlsharp_tpu/utils: graph_print,
graph_dump_dot, print_objects, and the checks checked, check and
assert_all_finite)."""

from .debug import (CheckError, assert_all_finite, check, checked,
                    graph_print, print_objects)
from .graphviz import graph_dump_dot

__all__ = ["CheckError", "assert_all_finite", "check", "checked",
           "graph_dump_dot", "graph_print", "print_objects"]
