"""Sharding rules and the local shards they give (port of
ggmlsharp_tpu/parallel/sharding.py).

The specs carry the JAX trees' shapes: ``COL`` shards a weight's output
rows over ``model`` (column-parallel: q/k/v, gate/up, fc), ``ROW`` its
input columns (row-parallel: wo, w_down, c_proj; the output is summed over
``model``), ``REP`` replicates. The JAX package hands the specs to GSPMD;
here ``shard_params`` slices each rank's local shard out of the full tree,
and the models issue the collectives (``parallel.comm``).

Three rules differ from a plain contiguous slice:
  * A fused weight (``wqkv = [q; k; v]``, ``w_gate_up = [gate; up]``,
    GPT-2's ``c_attn_w`` and ``c_attn_b``) shards each of its parts: rank
    r holds its own heads of q, k and v (its own rows of gate and up),
    concatenated in the same order, so the local forward splits its shard
    as the whole model splits the whole weight. A contiguous chunk would
    mix q, k and v heads across ranks.
  * A QTensor's planes are ggml's fields, blocked along the last axis
    (``quant.formats``): COL slices rows of every plane; ROW slices the
    last axis of every plane at block boundaries, so K/model must be a
    whole number of blocks (Q4_0 32, the k-quants 256). A shard that does
    not divide raises a ValueError naming the weight.
  * The vocabulary tables (``VOCAB``: llama's ``tok_embd`` and ``output``,
    GPT-2's ``wte``) are padded with zero rows to a multiple of ``model``;
    the padding lies on the last rank and the models cut the gathered
    logits back to n_vocab.

``shard_params`` drops the single-device fused routes' marks
(``mlp_fused``, ``layer_fused``): those kernels are never reached with a
shard. The returned tree carries a ``Sharding`` under the key ``"tp"`` (the
axis the models reduce over, the mesh and the specs); tree walkers pass it
through.
"""
from __future__ import annotations

import torch

from ..quant.formats import QTensor, _WIRE
from .comm import Axis, axis

TP_KEY = "tp"


class P(tuple):
    """A PartitionSpec: one mesh dim name (or None) an array axis.
    ``fused``: the parts a fused weight's rows are made of ("qkv",
    "gate_up", "thirds"); ``pad``: pad rows to a multiple of the axis."""

    def __new__(cls, *axes, fused: str | None = None, pad: bool = False):
        obj = super().__new__(cls, axes)
        obj.fused, obj.pad = fused, pad
        return obj

    def __repr__(self):
        args = [repr(a) for a in self] + \
            ([f"fused={self.fused!r}"] if self.fused else []) + \
            (["pad=True"] if self.pad else [])
        return f"P({', '.join(args)})"


COL = P("model", None)  # shard output features
ROW = P(None, "model")  # shard input features (sum on the output)
REP = P()  # replicated
VOCAB = P("model", None, pad=True)  # vocabulary rows, padded


def shard_qtensor_spec(qt: QTensor, spec: P) -> dict:
    """Per-plane specs for a quantized 2-D weight sharded by ``spec``."""
    return {k: spec for k in qt.planes}


def gpt2_param_specs():
    """The spec tree of models.gpt2.init_params."""
    blk = {
        "ln_1": {"g": REP, "b": REP},
        "attn": {
            "c_attn_w": P("model", None, fused="thirds"),
            "c_attn_b": P("model", fused="thirds"),
            "c_proj_w": ROW,
            "c_proj_b": REP,
        },
        "ln_2": {"g": REP, "b": REP},
        "mlp": {
            "c_fc_w": COL,
            "c_fc_b": P("model"),
            "c_proj_w": ROW,
            "c_proj_b": REP,
        },
    }
    return {"wte": VOCAB, "wpe": REP, "ln_f": {"g": REP, "b": REP},
            "blocks": blk}


def llama_param_specs():
    """The spec tree of models.llama's trees (separate or fused weights)."""
    blk = {
        "attn_norm": REP,
        "wq": COL,
        "wk": COL,
        "wv": COL,
        "wqkv": P("model", None, fused="qkv"),
        "wo": ROW,
        "ffn_norm": REP,
        "w_gate": COL,
        "w_up": COL,
        "w_gate_up": P("model", None, fused="gate_up"),
        "w_down": ROW,
    }
    return {"tok_embd": VOCAB, "norm": REP, "output": VOCAB, "blocks": blk}


def kv_cache_spec():
    """Per-layer head-major buffers [B, H_kv, T, D] and scales
    [B, H_kv, T, 1]: heads over model, batch over data."""
    main = P("data", "model", None, None)
    return {"k": main, "v": main, "k_scale": main, "v_scale": main,
            "length": P("data")}


class Sharding:
    """What a sharded tree carries under ``"tp"``: the model Axis the
    forwards reduce over, the mesh, the spec tree, and the vocabulary rows
    each padded table had ({path: rows})."""

    tree_static = True

    def __init__(self, ax: Axis, mesh, specs, rows: dict):
        self.axis, self.mesh, self.specs, self.rows = ax, mesh, specs, rows

    def __repr__(self):
        return f"Sharding({self.axis!r})"


def _rows(t):
    return t.shape[0]


def _take_rows(t, lo, n):
    if isinstance(t, QTensor):
        return QTensor(t.gtype, (n,) + tuple(t.shape[1:]),
                       {k: v[lo:lo + n] for k, v in t.planes.items()})
    return t[lo:lo + n]


def _cat_rows(parts):
    if isinstance(parts[0], QTensor):
        planes = {k: torch.cat([p.planes[k] for p in parts], dim=0)
                  for k in parts[0].planes}
        return QTensor(parts[0].gtype, (sum(p.shape[0] for p in parts),)
                       + tuple(parts[0].shape[1:]), planes)
    return torch.cat(parts, dim=0)


def _pad_rows(t, n):
    if isinstance(t, QTensor):
        planes = {k: torch.cat([v, v.new_zeros((n,) + tuple(v.shape[1:]))])
                  for k, v in t.planes.items()}
        return QTensor(t.gtype, (t.shape[0] + n,) + tuple(t.shape[1:]),
                       planes)
    return torch.cat([t, t.new_zeros((n,) + tuple(t.shape[1:]))])


def fused_parts(kind: str, t, block: dict) -> list:
    """The row counts of a fused weight's parts, from its block: wqkv's q
    rows are wo's inputs, k and v share the rest; gate_up and GPT-2's qkv
    split evenly."""
    n = _rows(t)
    if kind == "qkv":
        nq = block["wo"].shape[1]
        return [nq, (n - nq) // 2, (n - nq) // 2]
    if kind == "gate_up":
        return [n // 2, n // 2]
    if kind == "thirds":
        return [n // 3] * 3
    raise ValueError(f"unknown fused layout {kind!r}")


def col_shard(t, spec: P, rank: int, size: int, path: str, block=None):
    """Rank ``rank``'s rows of a COL leaf (see the module docstring)."""
    parts = fused_parts(spec.fused, t, block) if spec.fused else [_rows(t)]
    if spec.pad and _rows(t) % size:
        t = _pad_rows(t, size - _rows(t) % size)
        parts = [_rows(t)]
    out, lo = [], 0
    for n in parts:
        if n % size:
            raise ValueError(f"{path}: {n} rows do not shard over the model "
                             f"axis of {size}")
        out.append(_take_rows(t, lo + rank * (n // size), n // size))
        lo += n
    return out[0] if len(out) == 1 else _cat_rows(out)


def row_shard(t, rank: int, size: int, path: str):
    """Rank ``rank``'s input columns of a ROW leaf: the last axis of every
    plane, at block boundaries for a QTensor."""
    K = t.shape[-1]
    if isinstance(t, QTensor):
        bs = _WIRE[t.gtype][0]
        if K % size or (K // size) % bs:
            raise ValueError(
                f"{path}: the K-shard of {K} over the model axis of {size} "
                f"is {K / size:g} columns, not a whole number of "
                f"{t.gtype.name} blocks of {bs}")
        planes = {}
        for k, v in t.planes.items():
            w = v.shape[-1] // size
            planes[k] = v[..., rank * w:(rank + 1) * w].contiguous()
        return QTensor(t.gtype, tuple(t.shape[:-1]) + (K // size,), planes)
    if K % size:
        raise ValueError(f"{path}: {K} columns do not shard over the model "
                         f"axis of {size}")
    w = K // size
    return t[..., rank * w:(rank + 1) * w].contiguous()


def shard_leaf(t, spec, rank: int, size: int, path: str, block=None):
    """The local shard of one leaf under ``spec`` (model dim only)."""
    if t is None or spec is None or "model" not in tuple(spec):
        return t
    dim = tuple(spec).index("model")
    if dim == 0:
        return col_shard(t, spec, rank, size, path, block)
    if dim == len(spec) - 1:
        return row_shard(t, rank, size, path)
    raise ValueError(f"{path}: spec {spec} shards a middle axis")


def _specs_walk(params, specs, fn):
    """fn(leaf, spec, path, block) over the leaves of a parameter tree,
    the spec tree broadcast over lists (one ``blocks`` dict for every
    block); keys absent from the specs replicate."""

    def walk(p, s, path, block):
        if isinstance(p, dict):
            return {k: walk(v, s.get(k, REP) if isinstance(s, dict) else s,
                            f"{path}/{k}" if path else k, p)
                    for k, v in p.items()}
        if isinstance(p, list):
            return [walk(v, s, f"{path}/{i}", block)
                    for i, v in enumerate(p)]
        return fn(p, s, path, block)

    return walk(params, specs, "", None)


def shard_params(params, specs, mesh, axis_name: str = "model"):
    """This rank's shard of a full parameter tree under ``specs`` on
    ``mesh`` (its ``model`` dim; ``data`` replicates). Refuses a tree that
    is already sharded."""
    if isinstance(params, dict) and TP_KEY in params:
        raise ValueError("the tree is sharded already")
    ax = axis(mesh, axis_name)
    strip = ("mlp_fused", "layer_fused")
    rows = {}

    def place(t, s, path, block):
        if s is not None and getattr(s, "pad", False) and t is not None:
            rows[path] = _rows(t)
        return shard_leaf(t, s, ax.rank, ax.size, path, block)

    tree = dict(params)
    tree["blocks"] = [{k: v for k, v in b.items() if k not in strip}
                      for b in params["blocks"]]
    out = _specs_walk(tree, specs, place)
    out[TP_KEY] = Sharding(ax, mesh, specs, rows)
    return out


def shard_cache(cache, specs, mesh):
    """This rank's shard of a head-major models.kv_cache.KVCache under
    ``specs`` (kv_cache_spec(): heads over model, batch over data)."""
    from ..models.kv_cache import KVCache

    if cache.is_flat:
        raise ValueError("shard_cache takes a head-major cache; the flat "
                         "layout is single-device")
    names = mesh.mesh_dim_names

    def cut(x, spec):
        for dim, name in enumerate(spec):
            if name is None:
                continue
            if name not in names:
                raise ValueError(f"spec {spec} names {name!r}, not a dim of "
                                 f"the mesh {names}")
            ax = axis(mesh, name)
            n = x.shape[dim]
            if n % ax.size:
                raise ValueError(f"cache axis {dim} of {n} does not shard "
                                 f"over {name} of {ax.size}")
            w = n // ax.size
            x = x.narrow(dim, ax.rank * w, w)
        return x.contiguous()

    def place(bufs, spec):
        return None if bufs is None else [cut(x, spec) for x in bufs]

    return KVCache(place(cache.k, specs["k"]), place(cache.v, specs["v"]),
                   place(cache.k_scale, specs["k_scale"]),
                   place(cache.v_scale, specs["v_scale"]),
                   cut(cache.length, specs["length"]))
