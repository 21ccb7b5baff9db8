"""Port quantization (ggmlsharp_tpu_torch.quant) against the JAX package and
the independent C oracle (tests/golden/golden.bin). Everything here is
bit-exact: same f32 arithmetic, same rounding, same wire bytes."""
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu import GType as JGType
from ggmlsharp_tpu import dequantize as jdequantize
from ggmlsharp_tpu import quantize as jquantize
from ggmlsharp_tpu.io.gguf import qtensor_to_wire
from ggmlsharp_tpu_torch import GType, dequantize, quantize
from ggmlsharp_tpu_torch.quant.formats import (
    QTensor, concat_qtensors, from_wire, to_wire,
)

GOLD = os.path.join(os.path.dirname(__file__), "golden", "golden.bin")
ROWS, K = 4, 256
FORMATS = ["Q4_0", "Q8_0"]


@pytest.fixture(scope="module")
def gold():
    sections = {}
    with open(GOLD, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        (nl,) = struct.unpack_from("<I", data, off)
        off += 4
        name = data[off:off + nl].decode()
        off += nl
        (pb,) = struct.unpack_from("<I", data, off)
        off += 4
        sections[name] = data[off:off + pb]
        off += pb
    return sections


def _inputs(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.standard_normal(shape).astype(np.float32)
    if kind == "ties":  # repeated magnitudes: signed-absmax tie-breaking
        return (rng.integers(-3, 4, shape) * 0.25).astype(np.float32)
    if kind == "zeros":  # d = 0 blocks: the safe inverse
        x = rng.standard_normal(shape).astype(np.float32)
        x[:, :32] = 0.0
        return x
    raise ValueError(kind)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("kind,shape", [("normal", (8, 512)),
                                        ("ties", (4, 256)),
                                        ("zeros", (3, 96))])
def test_quantize_matches_jax_bit_exact(fmt, kind, shape):
    x = _inputs(kind, shape, seed=len(fmt) + shape[1])
    jqt = jax.jit(lambda a: jquantize(a, JGType[fmt]))(jnp.asarray(x))
    _, jwire = qtensor_to_wire(jqt)
    qt = quantize(torch.from_numpy(x), GType[fmt])
    assert to_wire(qt) == jwire
    np.testing.assert_array_equal(dequantize(qt).numpy(),
                                  np.asarray(jax.jit(jdequantize)(jqt)))


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantize_bf16_input_matches_jax(fmt):
    """bf16 weights (init_params' dtype) quantize through an f32 cast."""
    x = np.random.default_rng(1).standard_normal((4, 256)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    _, jwire = qtensor_to_wire(jquantize(xb.astype(jnp.float32), JGType[fmt]))
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    assert to_wire(quantize(xt, GType[fmt])) == jwire


@pytest.mark.parametrize("name", ["q4_0", "q8_0"])
def test_golden_wire_bytes(gold, name):
    x = np.frombuffer(gold[f"{name}.input"], np.float32).reshape(ROWS, K)
    qt = quantize(torch.from_numpy(x.copy()), GType[name.upper()])
    assert to_wire(qt) == gold[f"{name}.wire"]


@pytest.mark.parametrize("name", ["q4_0", "q8_0"])
def test_golden_wire_dequant(gold, name):
    qt = from_wire(GType[name.upper()], gold[f"{name}.wire"], (ROWS, K),
                   device="cpu")
    want = np.frombuffer(gold[f"{name}.dequant"], np.float32).reshape(ROWS, K)
    np.testing.assert_array_equal(dequantize(qt).numpy(), want)


@pytest.mark.parametrize("fmt", FORMATS)
def test_wire_round_trip_and_layout(fmt):
    x = torch.from_numpy(_inputs("normal", (2, 3, 64), 5))
    qt = quantize(x, GType[fmt])
    back = from_wire(GType[fmt], to_wire(qt), qt.shape, device="cpu")
    for key in ("qs", "d"):
        assert torch.equal(back[key], qt[key])
    n_payload = 32 if fmt == "Q4_0" else 64  # bytes of qs a row of 64
    assert tuple(qt["qs"].shape) == (2, 3, n_payload)
    assert tuple(qt["d"].shape) == (2, 3, 2) and qt["d"].dtype == torch.float16
    assert qt.nbytes() == len(to_wire(qt))


@pytest.mark.parametrize("fmt", FORMATS)
def test_from_wire_rejects_a_short_buffer(fmt):
    wire = to_wire(quantize(torch.ones(2, 64), GType[fmt]))
    with pytest.raises(ValueError, match="does not match"):
        from_wire(GType[fmt], wire[:-1], (2, 64), device="cpu")


def test_q4_0_in_block_nibble_order():
    """Byte j of a block: element j low nibble, element j+16 high nibble."""
    x = torch.zeros(1, 32)
    x[0, 0] = -8.0  # d = 1; element 0 -> q 0
    x[0, 16] = 7.0  # element 16 -> q 15
    qt = quantize(x, GType.Q4_0)
    assert float(qt["d"][0, 0]) == 1.0
    assert int(qt["qs"][0, 0]) == 0x00 | (15 << 4)
    assert int(qt["qs"][0, 1]) == 8 | (8 << 4)


def test_concat_qtensors_equals_quantized_concat():
    a = torch.from_numpy(_inputs("normal", (3, 64), 7))
    b = torch.from_numpy(_inputs("normal", (5, 64), 8))
    cat = concat_qtensors([quantize(a, GType.Q4_0), quantize(b, GType.Q4_0)])
    whole = quantize(torch.cat([a, b]), GType.Q4_0)
    assert isinstance(cat, QTensor) and cat.shape == (8, 64)
    assert to_wire(cat) == to_wire(whole)
