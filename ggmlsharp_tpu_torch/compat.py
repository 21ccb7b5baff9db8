"""ggml-style naming compatibility layer (port of ggmlsharp_tpu/compat.py).

One-stop mapping from the reference's public API to this package, for users
porting ggml/GGMLSharp code. Graph-building names return GTensor nodes
(ggml's deferred execution). There is no arena: a context only names the
device its tensors are made on (``ggml_init(device=...)``, the card by
default); ``ggml_free`` is a no-op kept for source compatibility.
"""
from __future__ import annotations

import torch

from .device import resolve_device
from .dtypes import GType
from .graph import builders as _B
from .graph.core import (
    Graph,
    GTensor,
    build_backward as _build_backward,
    build_forward as _build_forward,
    get_f32_1d as ggml_get_f32_1d,
    leaf,
    set_data,
    set_f32 as ggml_set_f32,
    set_param as _set_param,
)
from .optim import OptParams, opt as _opt, opt_default_params
from .optim.params import OptType
from .quant.formats import QTensor
from .utils import graph_dump_dot as ggml_graph_dump_dot
from .utils import graph_print as ggml_graph_print

# --- context: the device tensors are made on ------------------------------


class ggml_context:  # noqa: N801 - ggml naming
    def __init__(self, device):
        self.device = device


def ggml_init(params=None, device=None):
    """A context whose tensors live on ``device`` (the card by default)."""
    return ggml_context(resolve_device(device))


def ggml_free(ctx):
    pass


# --- tensor creation ------------------------------------------------------

_DTYPES = {
    GType.F32: torch.float32,
    GType.F16: torch.float16,
    GType.I8: torch.int8,
    GType.I16: torch.int16,
    GType.I32: torch.int32,
}


def _zeros(ctx, gtype, shape):
    return leaf(torch.zeros(shape, dtype=_DTYPES[GType(gtype)],
                            device=ctx.device))


def ggml_new_tensor_1d(ctx, gtype, ne0):
    return _zeros(ctx, gtype, (ne0,))


def ggml_new_tensor_2d(ctx, gtype, ne0, ne1):
    # ggml ne order: ne0 = fastest = last axis
    return _zeros(ctx, gtype, (ne1, ne0))


def ggml_new_tensor_3d(ctx, gtype, ne0, ne1, ne2):
    return _zeros(ctx, gtype, (ne2, ne1, ne0))


def ggml_new_tensor_4d(ctx, gtype, ne0, ne1, ne2, ne3):
    return _zeros(ctx, gtype, (ne3, ne2, ne1, ne0))


def ggml_new_f32(ctx, value):
    return leaf(torch.full((1,), value, dtype=torch.float32,
                           device=ctx.device))


def ggml_new_i32(ctx, value):
    return leaf(torch.full((1,), value, dtype=torch.int32, device=ctx.device))


def ggml_set_param(ctx, t):
    return _set_param(t)


def ggml_set_i32(t, v):
    t.data = torch.full(t.shape, v, dtype=t.dtype, device=t.device)
    return t


def ggml_get_i32_1d(t, i):
    return int(t.data.reshape(-1)[i])


# --- op builders (Ggml.cs:6846-7225 + the stubbed set) --------------------

def _ctx_op(fn):
    def wrapper(ctx, *args, **kwargs):
        return fn(*args, **kwargs)

    wrapper.__name__ = "ggml_" + fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


ggml_dup = _ctx_op(_B.dup)
ggml_add = _ctx_op(_B.add)
ggml_sub = _ctx_op(_B.sub)
ggml_mul = _ctx_op(_B.mul)
ggml_div = _ctx_op(_B.div)
ggml_sqr = _ctx_op(_B.sqr)
ggml_sqrt = _ctx_op(_B.sqrt)
ggml_sum = _ctx_op(_B.sum)
ggml_mean = _ctx_op(_B.mean)
ggml_abs = _ctx_op(_B.abs_)
ggml_sgn = _ctx_op(_B.sgn)
ggml_neg = _ctx_op(_B.neg)
ggml_step = _ctx_op(_B.step)
ggml_relu = _ctx_op(_B.relu)
ggml_gelu = _ctx_op(_B.gelu)
ggml_silu = _ctx_op(_B.silu)
ggml_norm = _ctx_op(_B.norm)
ggml_rms_norm = _ctx_op(_B.rms_norm)
ggml_mul_mat = _ctx_op(_B.mul_mat)
ggml_scale = _ctx_op(_B.scale)
ggml_cpy = _ctx_op(_B.cpy)
ggml_cont = _ctx_op(_B.cont)
ggml_transpose = _ctx_op(_B.transpose)
ggml_reshape = _ctx_op(_B.reshape)
ggml_permute = _ctx_op(_B.permute)
ggml_view_1d = _ctx_op(_B.view)


def ggml_view_2d(ctx, a, ne0, ne1, offset_elems=0):
    return _B.view(a, (ne1, ne0), offset_elems)


def ggml_view_3d(ctx, a, ne0, ne1, ne2, offset_elems=0):
    return _B.view(a, (ne2, ne1, ne0), offset_elems)


def ggml_reshape_2d(ctx, a, ne0, ne1):
    return _B.reshape(a, (ne1, ne0))


def ggml_reshape_3d(ctx, a, ne0, ne1, ne2):
    return _B.reshape(a, (ne2, ne1, ne0))
ggml_get_rows = _ctx_op(_B.get_rows)
ggml_diag_mask_inf = _ctx_op(_B.diag_mask_inf)
ggml_soft_max = _ctx_op(_B.soft_max)
ggml_rope = _ctx_op(_B.rope)
ggml_alibi = _ctx_op(_B.alibi)
ggml_conv_1d_1s = _ctx_op(_B.conv_1d_1s)
ggml_conv_1d_2s = _ctx_op(_B.conv_1d_2s)
ggml_flash_attn = _ctx_op(_B.flash_attn)
ggml_flash_ff = _ctx_op(_B.flash_ff)
ggml_map_unary_f32 = _ctx_op(_B.map_unary)
ggml_map_binary_f32 = _ctx_op(_B.map_binary)


# --- shape predicates & accessors (Ggml.cs:3766-3785, 8324-8407) ----------

def ggml_nelements(t):
    n = 1
    for s in t.shape:
        n *= s
    return n


def ggml_nrows(t):
    n = 1
    for s in t.shape[:-1]:
        n *= s
    return n


def ggml_nbytes(t):
    d = t.data if isinstance(t, GTensor) else t
    if isinstance(d, QTensor):
        return d.nbytes()
    return ggml_nelements(t) * d.element_size()


def ggml_is_scalar(t):
    return ggml_nelements(t) == 1


def ggml_is_vector(t):
    return len(t.shape) == 1 or all(s == 1 for s in t.shape[:-1])


def ggml_is_matrix(t):
    return len([s for s in t.shape if s > 1]) <= 2


def ggml_can_mul_mat(a, b):
    return a.shape[-1] == b.shape[-1]


def ggml_are_same_shape(a, b):
    return tuple(a.shape) == tuple(b.shape)


def ggml_is_quantized(t):
    d = t.data if isinstance(t, GTensor) else t
    return isinstance(d, QTensor)


def ggml_dup_tensor(ctx, t):
    return leaf(torch.zeros(t.shape, dtype=t.dtype, device=ctx.device))


def ggml_view_tensor(ctx, t):
    """Shares data in the reference (Ggml.cs:3751); functionally a dup node."""
    return _B.dup(t)


def ggml_set_f32_1d(t, i, v):
    flat = t.data.reshape(-1).clone()
    flat[i] = v
    t.data = flat.reshape(t.shape)
    return t


def ggml_set_i32_1d(t, i, v):
    return ggml_set_f32_1d(t, i, v)


def ggml_print_objects(tree, name="objects"):
    from .utils.debug import print_objects

    data = tree.data if isinstance(tree, GTensor) else tree
    return print_objects(data, name)


def ggml_repeat(ctx, a, like):
    """ggml_repeat(a, b): tile a to b's shape."""
    shape = like.shape if isinstance(like, GTensor) else tuple(like)
    return _B.repeat(a, shape)


# --- inplace variants (Ggml.cs _impl inplace=true): functionally identical
# here, since a graph node's value is a new tensor
ggml_add_inplace = ggml_add
ggml_sub_inplace = ggml_sub
ggml_mul_inplace = ggml_mul
ggml_div_inplace = ggml_div
ggml_scale_inplace = ggml_scale
ggml_sqr_inplace = ggml_sqr
ggml_sqrt_inplace = ggml_sqrt
ggml_abs_inplace = ggml_abs
ggml_sgn_inplace = ggml_sgn
ggml_neg_inplace = ggml_neg
ggml_step_inplace = ggml_step
ggml_relu_inplace = ggml_relu
ggml_gelu_inplace = ggml_gelu
ggml_silu_inplace = ggml_silu
ggml_norm_inplace = ggml_norm
ggml_rms_norm_inplace = ggml_rms_norm
ggml_diag_mask_inf_inplace = ggml_diag_mask_inf
ggml_soft_max_inplace = ggml_soft_max


# --- graph API ------------------------------------------------------------

def ggml_build_forward(t) -> Graph:
    return _build_forward(t)


def ggml_build_backward(ctx, gf: Graph, keep: bool) -> Graph:
    return _build_backward(gf, keep=keep)


def ggml_build_forward_expand(graph: Graph, t):
    graph.build_expand(t)


def ggml_graph_compute(ctx, graph: Graph):
    graph.compute()


def ggml_graph_reset(graph: Graph):
    graph.reset()


# --- optimizers -----------------------------------------------------------

GGML_OPT_ADAM = OptType.ADAM
GGML_OPT_LBFGS = OptType.LBFGS


def ggml_opt_default_params(type_):
    return opt_default_params(type_)


def ggml_opt(ctx, params: OptParams, f: GTensor):
    res, fx = _opt(f, params)
    return res
