"""Checkpoints of parameter trees, QTensors and optimizer state included
(port of the npz half of ggmlsharp_tpu/io/checkpoint.py).

The layout is the JAX package's, so that a float checkpoint crosses between
the packages both ways: ``arrays.npz`` holds every array leaf under its
'/'-joined path, a QTensor's planes under ``path/__q__/plane``; ``meta.json``
holds ``{"meta": ..., "step": step}``, where meta maps each QTensor's path to
its gtype and shape and lists the lists (``__lists__``, path and length) and
the ``None`` leaves (``__none__``). Two entries are the port's own:

  * a QTensor's entry carries ``"layout": "wire"``: its planes are ggml's
    wire fields (``quant.formats``). A QTensor entry without it was written
    by the JAX package, whose planes are TPU layouts; loading it raises a
    ValueError that names the leaf.
  * ``__dtypes__`` maps each bfloat16 leaf's path to ``"bfloat16"``. numpy
    has no bf16: the leaf is stored as 2-byte void words (``|V2``), which is
    also how numpy stores the JAX package's ml_dtypes bfloat16 arrays, so a
    ``|V2`` leaf without an entry is read as bfloat16 too.

``save_checkpoint_sharded`` / ``load_checkpoint_sharded`` are the orbax
pair's counterpart over ``torch.distributed.checkpoint`` (DCP): every leaf
of a sharded tree (``parallel.shard_params``; each QTensor plane) is
wrapped as a ``DTensor`` with the placements of its spec, so each rank
writes its own shards under ``arrays/``; a fused weight's parts are kept
apart (``path#j``) so that each is one logical tensor, and a padded
vocabulary table records its rows. ``meta.json`` (tree structure, QTensor
gtypes and whole shapes, the step) is written by rank 0 alone. A JAX orbax
checkpoint (``"orbax": true`` in its ``meta.json``) is refused by name.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..device import resolve_device
from ..dtypes import GType
from ..quant.formats import QTensor, plane_specs

_SPECIAL = ("__lists__", "__none__", "__dtypes__")


def _host(path, x, dtypes):
    """A leaf as the numpy array npz stores."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            dtypes[path] = "bfloat16"
            return x.view(torch.int16).numpy().view("V2")
        return x.numpy()
    return np.asarray(x)


def _flatten_tree(tree):
    """-> ({path: numpy array}, meta)."""
    out, meta, dtypes = {}, {}, {}

    def walk(node, path):
        if isinstance(node, QTensor):
            meta[path] = {"gtype": int(node.gtype), "shape": list(node.shape),
                          "layout": "wire"}
            for k, v in node.planes.items():
                out[f"{path}/__q__/{k}"] = _host(None, v, {})
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
            meta.setdefault("__lists__", []).append([path, len(node)])
        elif node is None:
            meta.setdefault("__none__", []).append(path)
        else:
            out[path] = _host(path, node, dtypes)

    walk(tree, "")
    if dtypes:
        meta["__dtypes__"] = dtypes
    return out, meta


def _tensor(arr, bf16: bool, dev) -> torch.Tensor:
    if bf16 or arr.dtype == np.dtype("V2"):
        arr = arr.view(np.int16)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(dev)


def _qtensor(path, m, planes, dev) -> QTensor:
    if m.get("layout") != "wire":
        raise ValueError(
            f"checkpoint leaf {path!r} is a QTensor in the JAX package's TPU "
            "plane layout; carry it across as ggml wire bytes "
            "(models.common.params_from_jax)")
    gtype, shape = GType(m["gtype"]), tuple(m["shape"])
    want = plane_specs(gtype, shape[-1])
    if set(planes) != set(want):
        raise ValueError(f"checkpoint leaf {path!r}: planes {sorted(planes)} "
                         f"are not {gtype.name}'s {sorted(want)}")
    return QTensor(gtype, shape, {k: torch.from_numpy(v.copy()).to(dev)
                                  for k, v in planes.items()})


def _unflatten_tree(flat: dict, meta: dict, dev):
    tree: dict = {}
    lists = {p: n for p, n in meta.get("__lists__", [])}
    dtypes = meta.get("__dtypes__", {})
    qmeta = {k: v for k, v in meta.items() if k not in _SPECIAL}

    def insert(path, value):
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    qplanes: dict[str, dict] = {}
    for key, arr in flat.items():
        if "/__q__/" in key:
            qpath, plane = key.split("/__q__/")
            qplanes.setdefault(qpath, {})[plane] = arr
        else:
            insert(key, _tensor(arr, dtypes.get(key) == "bfloat16", dev))
    for qpath, planes in qplanes.items():
        insert(qpath, _qtensor(qpath, qmeta[qpath], planes, dev))
    for path in meta.get("__none__", []):
        insert(path, None)

    def listify(node, path=""):
        if isinstance(node, dict):
            if path in lists:
                return [listify(node[str(i)], f"{path}/{i}")
                        for i in range(lists[path])]
            return {k: listify(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        return node

    return listify(tree)


def save_checkpoint(path: str, tree, step: int | None = None):
    """Write ``tree`` (dicts, lists, tensors, QTensors, None) and ``step``
    into the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    flat, meta = _flatten_tree(tree)
    np.savez(os.path.join(path, "arrays.npz"), **flat)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"meta": meta, "step": step}, f)


def load_checkpoint(path: str, device=None):
    """-> (tree, step), every tensor on ``device`` (the card unless the
    caller asks for another)."""
    dev = resolve_device(device)
    with open(os.path.join(path, "meta.json")) as f:
        m = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten_tree(flat, m["meta"], dev), m.get("step")


# --- the sharded pair (torch.distributed.checkpoint) ----------------------


def _sharded_entries(tree):
    """-> ([(key, local tensor, sharded dim or None)], meta): the tree's
    leaves as DCP entries under its own specs (a tree without a ``"tp"``
    entry is all replicated)."""
    from ..parallel.sharding import REP, TP_KEY, _specs_walk, fused_parts

    shd = tree.get(TP_KEY) if isinstance(tree, dict) else None
    size = shd.axis.size if shd is not None else 1
    body = {k: v for k, v in tree.items() if k != TP_KEY} \
        if isinstance(tree, dict) else tree
    entries, meta = [], {}

    def leaf(t, spec, path, block):
        if t is None:
            return
        spec = spec if spec is not None else REP
        dim = tuple(spec).index("model") \
            if "model" in tuple(spec) and size > 1 else None
        parts = fused_parts(spec.fused, t, block) \
            if dim == 0 and getattr(spec, "fused", None) else [t.shape[0]]
        m = {}
        if len(parts) > 1:
            m["parts"] = len(parts)
        if dim == 0 and path in shd.rows:
            m["rows"] = shd.rows[path]
        if isinstance(t, QTensor):
            shape = list(t.shape)
            if dim is not None:
                shape[0 if dim == 0 else -1] *= size
            if "rows" in m:
                shape[0] = m["rows"]
            m.update(gtype=int(t.gtype), shape=shape,
                     local_shape=list(t.shape), layout="wire")
        if m:
            meta[path] = m
        arrays = t.planes.items() if isinstance(t, QTensor) else [(None, t)]
        for plane, a in arrays:
            key = path if plane is None else f"{path}/__q__/{plane}"
            if len(parts) == 1:
                entries.append((key, a, None if dim is None
                                else (0 if dim == 0 else a.dim() - 1)))
                continue
            lo = 0
            for j, n in enumerate(parts):
                entries.append((f"{key}#{j}", a[lo:lo + n], 0))
                lo += n

    def structure(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                structure(v, f"{path}/{k}" if path else k)
        elif isinstance(node, (list, tuple)):
            meta.setdefault("__lists__", []).append([path, len(node)])
            for i, v in enumerate(node):
                structure(v, f"{path}/{i}")
        elif node is None:
            meta.setdefault("__none__", []).append(path)

    structure(body, "")
    _specs_walk(body, shd.specs if shd is not None else {}, leaf)
    return entries, meta


def _dtensor(a, shd, dim):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = shd.mesh
    place = [Replicate()] * mesh.ndim
    place[mesh.mesh_dim_names.index(shd.axis.name)] = Shard(dim)
    return DTensor.from_local(a.contiguous(), mesh, place, run_check=False)


def save_checkpoint_sharded(path: str, tree, step: int | None = None):
    """Write ``tree`` (a sharded tree from parallel.shard_params, or any
    tree, then replicated) and ``step`` under the directory ``path``, each
    rank writing its own shards; call it on every rank."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    from ..parallel.sharding import TP_KEY

    os.makedirs(path, exist_ok=True)
    entries, meta = _sharded_entries(tree)
    shd = tree.get(TP_KEY) if isinstance(tree, dict) else None
    state = {k: (a.detach() if dim is None else _dtensor(a.detach(), shd, dim))
             for k, a, dim in entries}
    dcp.save(state, checkpoint_id=os.path.join(os.path.abspath(path),
                                                "arrays"))
    # meta.json marks a whole checkpoint (CheckpointedLoop skips a step
    # directory without it): written once every rank's arrays are, and
    # moved into place whole
    multi = dist.is_initialized() and dist.get_world_size() > 1
    if multi:
        dist.barrier()
    if not multi or dist.get_rank() == 0:
        tmp = os.path.join(path, "meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump({"meta": meta, "step": step, "dcp": True}, f)
        os.replace(tmp, os.path.join(path, "meta.json"))
    if multi:
        dist.barrier()


def _read_meta(path):
    with open(os.path.join(path, "meta.json")) as f:
        m = json.load(f)
    if m.get("orbax"):
        raise ValueError(
            f"{path} is an orbax checkpoint written by the JAX package's "
            "save_checkpoint_sharded; the port reads its own "
            "(torch.distributed.checkpoint) checkpoints, and the npz ones")
    if not m.get("dcp"):
        raise ValueError(f"{path} is not a sharded checkpoint (load it with "
                         "load_checkpoint)")
    return m


def load_checkpoint_sharded(path: str, like=None, device=None):
    """-> (tree, step). like: a tree of the saved structure whose leaves
    give the layout to restore into (a sharded tree restores each rank's
    own shards, with like's ``"tp"`` entry); without it every leaf
    restores whole, on ``device`` (the card unless the caller asks for
    another). Call it on every rank when ``like`` is sharded."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    from ..parallel.sharding import TP_KEY

    m = _read_meta(path)
    meta = m["meta"]
    target = os.path.join(os.path.abspath(path), "arrays")
    shd = like.get(TP_KEY) if isinstance(like, dict) else None
    if shd is not None:
        entries, _ = _sharded_entries(like)
        state = {k: (torch.empty_like(a) if dim is None
                     else _dtensor(torch.empty_like(a), shd, dim))
                 for k, a, dim in entries}
        dcp.load(state, checkpoint_id=target)
        dev = {k: a.device for k, a, _ in entries}
        flat = {k: (v.to_local() if dim is not None else v).to(dev[k])
                for (k, _, dim), v in zip(entries, state.values())}
        tree = _rebuild(flat, meta, local=True)
        tree[TP_KEY] = shd
        return tree, m.get("step")
    dev = resolve_device(device)
    md = dcp.FileSystemReader(target).read_metadata().state_dict_metadata
    state = {k: torch.empty(tuple(v.size), dtype=v.properties.dtype)
             for k, v in md.items()}
    dcp.load(state, checkpoint_id=target,
             no_dist=not (dist.is_initialized()
                          and dist.get_world_size() > 1))
    flat = {k: v.to(dev) for k, v in state.items()}
    return _rebuild(flat, meta, local=False), m.get("step")


def _rebuild(flat: dict, meta: dict, local: bool):
    """The tree from DCP entries: a fused leaf's parts concatenated, a
    padded table cut back to its rows (when restored whole), QTensors
    rebuilt with their local or whole shapes."""
    joined: dict[str, dict] = {}
    for key, v in flat.items():
        base, _, j = key.partition("#")
        joined.setdefault(base, {})[int(j) if j else 0] = v
    arrays = {k: (parts[0] if len(parts) == 1 else
                  torch.cat([parts[j] for j in sorted(parts)], dim=0))
              for k, parts in joined.items()}
    tree: dict = {}
    lists = {p: n for p, n in meta.get("__lists__", [])}

    def insert(p, value):
        parts = p.split("/")
        node = tree
        for q in parts[:-1]:
            node = node.setdefault(q, {})
        node[parts[-1]] = value

    qplanes: dict[str, dict] = {}
    for key, a in arrays.items():
        if "/__q__/" in key:
            qp, plane = key.split("/__q__/")
            qplanes.setdefault(qp, {})[plane] = a
        else:
            rows = meta.get(key, {}).get("rows")
            insert(key, a[:rows] if rows and not local else a)
    for qp, planes in qplanes.items():
        mm = meta[qp]
        rows = mm.get("rows")
        if rows and not local:
            planes = {k: v[:rows] for k, v in planes.items()}
        shape = mm["local_shape"] if local else mm["shape"]
        insert(qp, QTensor(GType(mm["gtype"]), shape, planes))
    for p in meta.get("__none__", []):
        insert(p, None)

    def listify(node, p=""):
        if isinstance(node, dict):
            if p in lists:
                return [listify(node.get(str(i)), f"{p}/{i}")
                        for i in range(lists[p])]
            return {k: listify(v, f"{p}/{k}" if p else k)
                    for k, v in node.items()}
        return node

    return listify(tree)
