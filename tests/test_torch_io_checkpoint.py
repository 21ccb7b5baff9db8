"""The port's checkpoints, on the CPU: a round trip of every kind of leaf,
and float checkpoints crossing between the packages both ways in the JAX
package's layout (arrays.npz + meta.json). A JAX checkpoint holding a
QTensor (TPU planes) is refused."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu import quantize as jquantize
from ggmlsharp_tpu.dtypes import GType as JGType
from ggmlsharp_tpu.io import checkpoint as jckpt
from ggmlsharp_tpu_torch import GType, quantize
from ggmlsharp_tpu_torch.io import checkpoint
from ggmlsharp_tpu_torch.quant.formats import FORMATS, QTensor, to_wire


def _float_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "dense": torch.randn(3, 5, generator=g),
        "half": torch.randn(4, generator=g).half(),
        "bf16": torch.randn(2, 3, generator=g).to(torch.bfloat16),
        "ints": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        "nested": {"a": torch.ones(3), "lst": [torch.zeros(2),
                                               {"deep": torch.full((2,), 7.0)},
                                               None]},
        "missing": None,
    }


def _equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}/{i}")
    elif a is None:
        assert b is None, path
    elif isinstance(a, QTensor):
        assert isinstance(b, QTensor) and (a.gtype, a.shape) == \
            (b.gtype, b.shape), path
        for k in a.planes:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), \
                (path, k)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_roundtrip_every_leaf(tmp_path):
    """Dense f32 / f16 / bf16 / int leaves, a QTensor of every block format,
    nested lists, None and the step come back bit for bit."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 512)).astype(np.float32))
    tree = {**_float_tree(),
            "quant": {GType(g).name: quantize(x, g) for g in FORMATS}}
    path = str(tmp_path / "ck")
    checkpoint.save_checkpoint(path, tree, step=7)
    back, step = checkpoint.load_checkpoint(path, device="cpu")
    assert step == 7
    _equal(tree, back)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)["meta"]
    assert meta["__dtypes__"] == {"bf16": "bfloat16"}
    assert meta["quant/Q4_K"]["layout"] == "wire"


def test_jax_float_checkpoint_loads_in_the_port(tmp_path):
    tree = {"w": jnp.arange(6.0, dtype=jnp.float32).reshape(2, 3) / 7,
            "h": jnp.asarray([1.5, -2.25], jnp.float16),
            "b": jnp.asarray([0.1, 3.0, -7.5], jnp.bfloat16),
            "nested": {"lst": [jnp.zeros((2,)), jnp.ones((2,))]},
            "missing": None}
    path = str(tmp_path / "j")
    jckpt.save_checkpoint(path, tree, step=3)
    back, step = checkpoint.load_checkpoint(path, device="cpu")
    assert step == 3 and back["missing"] is None
    np.testing.assert_array_equal(back["w"].numpy(), np.asarray(tree["w"]))
    assert back["h"].dtype == torch.float16
    np.testing.assert_array_equal(back["h"].numpy(), np.asarray(tree["h"]))
    # numpy writes the ml_dtypes bfloat16 leaf as |V2: read as bf16 bits
    assert back["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        back["b"].view(torch.int16).numpy(),
        np.asarray(tree["b"]).view(np.int16))
    assert isinstance(back["nested"]["lst"], list)
    np.testing.assert_array_equal(back["nested"]["lst"][1].numpy(), 1.0)


def test_port_float_checkpoint_loads_in_jax(tmp_path):
    tree = _float_tree(1)
    path = str(tmp_path / "t")
    checkpoint.save_checkpoint(path, tree, step=11)
    back, step = jckpt.load_checkpoint(path)
    assert step == 11 and back["missing"] is None
    for key in ("dense", "half", "ints"):
        np.testing.assert_array_equal(back[key], tree[key].numpy())
    np.testing.assert_array_equal(back["nested"]["lst"][1]["deep"], 7.0)
    assert back["nested"]["lst"][2] is None
    # the bf16 leaf reaches JAX as its own bf16 leaves do: 2-byte words
    np.testing.assert_array_equal(
        np.asarray(back["bf16"]).view(np.int16),
        tree["bf16"].view(torch.int16).numpy())


@pytest.mark.parametrize("fmt", ["Q4_0", "Q8_0"])
def test_jax_qtensor_checkpoint_is_refused(tmp_path, fmt):
    x = np.random.default_rng(0).standard_normal((4, 256)).astype(np.float32)
    tree = {"blk": [{"w": jquantize(jnp.asarray(x), JGType[fmt])}],
            "b": jnp.zeros(3)}
    path = str(tmp_path / "j")
    jckpt.save_checkpoint(path, tree)
    with pytest.raises(ValueError, match="'blk/0/w'"):
        checkpoint.load_checkpoint(path, device="cpu")


def test_qtensor_with_foreign_planes_is_refused(tmp_path):
    """A QTensor entry marked as the port's whose planes are not its format's
    is refused too."""
    q = quantize(torch.ones(2, 64), GType.Q4_0)
    path = str(tmp_path / "t")
    checkpoint.save_checkpoint(path, {"q": QTensor(GType.Q4_1, q.shape,
                                                   q.planes)})
    with pytest.raises(ValueError, match="'q'"):
        checkpoint.load_checkpoint(path, device="cpu")
    checkpoint.save_checkpoint(path, {"q": q})
    back, _ = checkpoint.load_checkpoint(path, device="cpu")
    assert to_wire(back["q"]) == to_wire(q)


def test_loader_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    path = str(tmp_path / "t")
    checkpoint.save_checkpoint(path, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.load_checkpoint(path)
