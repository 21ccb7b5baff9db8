"""Per-op VJP table of the graph layer (port of
ggmlsharp_tpu/graph/op_defs.py): source to source, like ggml_compute_backward,
with full coverage.

Each entry maps an op name to fn(node, grad_node) -> one grad expression a
source (None: no gradient). Every VJP builds ordinary graph nodes, so
backward graphs are differentiable again (second order, Test1). Ops missing
here take ``core._generic_vjp`` (torch.autograd.grad of the op), which is
differentiable too. Beyond the reference (which has VJPs only for
dup/add/sub/mul/div/sqr/sqrt/sum/repeat/abs/neg/relu and mul_mat in its
activations): mean, scale, transpose and both mul_mat operands.
"""
from __future__ import annotations

from . import builders as B

VJP_TABLE = {}


def vjp(name):
    def deco(fn):
        VJP_TABLE[name] = fn
        return fn

    return deco


@vjp("dup")
def _(n, g):
    return (g,)


@vjp("add")
def _(n, g):
    return (g, g)


@vjp("sub")
def _(n, g):
    return (g, B.neg(g))


@vjp("mul")
def _(n, g):
    a, b = n.srcs
    return (B.mul(g, b), B.mul(g, a))


@vjp("div")
def _(n, g):
    a, b = n.srcs
    ga = B.div(g, b)
    gb = B.neg(B.mul(ga, n))  # -g*a/b² = -(g/b)*(a/b); n is a/b
    return (ga, gb)


@vjp("sqr")
def _(n, g):
    (a,) = n.srcs
    return (B.scale_const(B.mul(g, a), 2.0),)


@vjp("sqrt")
def _(n, g):
    return (B.scale_const(B.div(g, n), 0.5),)


@vjp("sum")
def _(n, g):
    (a,) = n.srcs
    return (B.repeat(g, a.shape),)


@vjp("mean")
def _(n, g):
    (a,) = n.srcs
    return (B.scale_const(B.repeat(g, a.shape), 1.0 / a.shape[-1]),)


@vjp("repeat")
def _(n, g):
    (a,) = n.srcs
    return (B.repeat_back(g, a.shape),)


@vjp("abs")
def _(n, g):
    (a,) = n.srcs
    return (B.mul(g, B.sgn(a)),)


@vjp("sgn")
def _(n, g):
    return (None,)


@vjp("step")
def _(n, g):
    return (None,)


@vjp("neg")
def _(n, g):
    return (B.neg(g),)


@vjp("relu")
def _(n, g):
    (a,) = n.srcs
    return (B.mul(g, B.step(a)),)


@vjp("transpose")
def _(n, g):
    return (B.transpose(g),)


@vjp("scale")
def _(n, g):
    a, s = n.srcs
    return (B.scale(g, s), B.sum(B.mul(g, a)))


@vjp("mul_mat")
def _(n, g):
    # c[..., n_out] = b[..., k] @ a[n_out, k]^T
    # da = Σ_... g ⊗ b  (the "outer product" the reference lacks, Ggml.cs:7449)
    # db = g @ a
    a, b = n.srcs
    da = B.mat_tb(g, b)  # g^T·b contracted over batch → [n_out, k]
    db = B.mat_nn(g, a)  # g·a → [..., k]
    return (da, db)
