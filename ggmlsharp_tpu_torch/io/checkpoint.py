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

The orbax pair (``save_checkpoint_sharded``) waits for the port's parallel
layer.
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
