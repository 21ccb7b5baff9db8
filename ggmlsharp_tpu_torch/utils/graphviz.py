"""Graphviz export (port of ggmlsharp_tpu/utils/graphviz.py:
ggml_graph_dump_dot). Params yellow, nodes with grads green, leafs gray;
edges from sources to node; an optional forward graph marks which backward
nodes it holds."""
from __future__ import annotations

from ..graph.core import Graph


def graph_dump_dot(gb: Graph, gf: Graph | None, filename: str) -> str:
    gf_uids = set()
    if gf is not None:
        gf_uids = {n.uid for n in gf.nodes} | {n.uid for n in gf.leafs}

    def node_id(n):
        return f"n{n.uid}"

    lines = ["digraph G {", "  newrank = true;", "  rankdir = LR;"]
    for n in gb.nodes + gb.leafs:
        if n.is_param:
            color = "yellow"
        elif n.grad is not None:
            color = "lightgreen" if n.uid in gf_uids or gf is None else "green"
        elif n.op == "none":
            color = "lightgray"
        else:
            color = "white"
        shape_s = "x".join(str(s) for s in (n.shape or ()))
        label = f"{n.name}|{n.op}|{shape_s}"
        lines.append(
            f'  {node_id(n)} [style=filled, fillcolor={color}, '
            f'shape=record, label="{label}"];'
        )
    for n in gb.nodes:
        for j, s in enumerate(n.srcs):
            lines.append(f'  {node_id(s)} -> {node_id(n)} [label="src{j}"];')
    lines.append("}")
    out = "\n".join(lines)
    with open(filename, "w") as f:
        f.write(out)
    return out
