"""A transformer decoder built purely through the ggml-style graph API of
the PyTorch/CUDA port (counterpart of examples/graph_transformer.py).

The reference declares GET_ROWS/DIAG_MASK_INF/SOFT_MAX/ROPE in its op enum
but stubs them; here they are graph builders: this example builds a
2-layer GPT-style decoder as a ggml expression DAG (build once -> set the
token leaf -> Graph.compute, the Test1 "re-run with new inputs" workflow)
and greedy-decodes a few tokens by recomputing the fixed-window graph.
Attention is soft_max(diag_mask_inf(k.q)) in the graph, not flash_attn.

    python examples/graph_transformer_torch.py [--device cuda]

Runs on the card unless --device cpu.
"""
import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def build_model(draw, device, V=96, S=16, E=32, H=4, L=2):
    """The decoder's graph. draw(shape) -> the next weight (a tensor; the
    weights are drawn in the order the JAX example draws them). Returns
    (token leaf, forward graph, logits node [S, V])."""
    import torch

    from ggmlsharp_tpu_torch.graph import build_forward, leaf
    from ggmlsharp_tpu_torch.graph import builders as B

    w = lambda *shape: leaf(draw(shape), device=device)
    tok = leaf(torch.zeros((S,), dtype=torch.int32), name="tokens",
               device=device)
    wte = w(V, E)
    x = B.get_rows(wte, tok)  # [S, E]
    hd = E // H
    for _ in range(L):
        h = B.rms_norm(x)
        q = B.reshape(B.mul_mat(w(E, E), h), (S, H, hd))
        k = B.reshape(B.mul_mat(w(E, E), h), (S, H, hd))
        v = B.reshape(B.mul_mat(w(E, E), h), (S, H, hd))
        # [S, H, hd] -> [H, S, hd], rope over positions 0..S-1
        q = B.rope(B.permute(q, (1, 0, 2)), 0)
        k = B.rope(B.permute(k, (1, 0, 2)), 0)
        v = B.permute(v, (1, 0, 2))
        att = B.scale_const(B.mul_mat(k, q), 1.0 / math.sqrt(hd))  # [H,S,S]
        att = B.soft_max(B.diag_mask_inf(att, 0))
        o = B.mul_mat(B.cont(B.transpose(v)), att)  # [H, S, hd]
        o = B.reshape(B.cont(B.permute(o, (1, 0, 2))), (S, E))
        x = B.add(x, B.mul_mat(w(E, E), o))
        h2 = B.rms_norm(x)
        x = B.add(x, B.mul_mat(w(E, 4 * E),
                               B.gelu(B.mul_mat(w(4 * E, E), h2))))
    logits = B.mul_mat(wte, B.rms_norm(x))  # [S, V] tied head
    return tok, build_forward(logits), logits


def greedy(tok, graph, logits, prompt, n_new, S=16):
    """Greedy decode by recomputing the fixed-window graph: each step sets
    the window (the last S tokens, zero-padded) and takes the argmax at the
    last filled position."""
    import torch

    from ggmlsharp_tpu_torch.graph import set_data

    toks = list(prompt)
    for _ in range(n_new):
        window = toks[-S:]
        padded = torch.zeros((S,), dtype=torch.int32)
        padded[:len(window)] = torch.tensor(window, dtype=torch.int32)
        set_data(tok, padded.to(tok.data.device))
        graph.compute()
        toks.append(int(logits.data[min(len(toks), S) - 1].argmax()))
    return toks[len(prompt):]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ggmlsharp_tpu_torch import resolve_device

    dev = resolve_device(args.device)
    gen = torch.Generator().manual_seed(0)
    draw = lambda shape: torch.randn(shape, generator=gen) * 0.08
    tok, graph, logits = build_model(draw, dev)
    print("graph-API transformer greedy decode:",
          greedy(tok, graph, logits, [5, 17, 33], 8))
    return 0


if __name__ == "__main__":
    sys.exit(main())
