"""Every block format of the port (ggmlsharp_tpu_torch.quant) against the JAX
package and the independent C oracle (tests/golden/golden.bin).

Quantizers and dequantizers are bit-exact with the JAX package run op by op
(eager). Under ``jax.jit`` XLA's CPU compiler rewrites ``amax / 127`` as
``amax * (1/127)`` and fuses the k-quant searches' products into their
reductions, so the jitted reference moves from its own eager run where an
f32 scale is kept unrounded (Q8_1, Q8_K) or a search keeps an argmin;
``test_jit_scale_is_a_reciprocal_product`` pins the first. The eager JAX
functions and ggml's C code divide, and sum 32 or 16 elements from left to
right, as the port does. Q4_2 and Q4_3 have no GGUF type: their wire bytes
are built here from the JAX planes (``jax_wire``)."""
import importlib
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
from ggmlsharp_tpu.io.gguf import qtensor_from_wire, qtensor_to_wire
from ggmlsharp_tpu.ops.embedding import get_rows as jget_rows
from ggmlsharp_tpu.quant.formats import (from_storage_order, to_swar,
                                         unpack_nibbles)
from ggmlsharp_tpu_torch import GType, dequantize, quantize
from ggmlsharp_tpu_torch.ops import get_rows
from ggmlsharp_tpu_torch.quant import registry
from ggmlsharp_tpu_torch.quant.formats import (
    FORMATS, from_wire, plane_specs, to_wire, wire_block_bytes,
)
from ggmlsharp_tpu_torch.quant.quantize import _sqrt_rn

GOLD = os.path.join(os.path.dirname(__file__), "golden", "golden.bin")
ROWS, K = 4, 256
ALL = [g.name for g in FORMATS]  # the eleven block formats
WEIGHTS = ["Q4_0", "Q4_1", "Q4_2", "Q4_3", "Q5_0", "Q5_1", "Q8_0", "Q4_K",
           "Q6_K"]


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


def jax_wire(jqt) -> bytes:
    """ggml wire bytes of a JAX QTensor: io.gguf for the GGUF types; for
    Q4_2/Q4_3 ggml's block (f16 d, [f16 m], 8 bytes, byte j: elements j and
    j + 8) from the JAX planes."""
    if jqt.gtype not in (JGType.Q4_2, JGType.Q4_3):
        return qtensor_to_wire(jqt)[1]
    k = jqt.shape[-1]
    rows, nb = int(np.prod(jqt.shape[:-1])), k // 16
    vals = np.asarray(from_storage_order(unpack_nibbles(jqt["qs"], k), 16))
    vals = vals.reshape(rows, nb, 16)
    parts = [np.asarray(jqt["d"]).reshape(rows, nb, 1).view(np.uint8)]
    if jqt.gtype == JGType.Q4_3:
        parts.append(np.asarray(jqt["m"]).reshape(rows, nb, 1).view(np.uint8))
    parts.append((vals[..., :8] | (vals[..., 8:] << 4)).astype(np.uint8))
    return np.concatenate(parts, axis=-1).tobytes()


def _inputs(kind, shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "ties":  # repeated magnitudes: signed-absmax tie-breaking
        x = (rng.integers(-3, 4, shape) * 0.25).astype(np.float32)
    elif kind == "zeros":  # an all-zero superblock and an all-zero block
        x[0, :256] = 0.0
        x[1:, 256:288] = 0.0
    elif kind == "shifted":  # one-signed blocks: the min terms matter
        x = x * 0.1 + 1.0
    return x


@pytest.mark.parametrize("fmt", ALL)
@pytest.mark.parametrize("kind", ["normal", "ties", "zeros", "shifted"])
def test_quantize_matches_jax_bit_exact(fmt, kind):
    x = _inputs(kind, (4, 512), seed=len(fmt) + len(kind))
    jqt = jquantize(jnp.asarray(x), JGType[fmt])
    qt = quantize(torch.from_numpy(x), GType[fmt])
    assert to_wire(qt) == jax_wire(jqt)
    np.testing.assert_array_equal(dequantize(qt).numpy(),
                                  np.asarray(jdequantize(jqt)))


@pytest.mark.parametrize("fmt", ["Q4_0", "Q4_1", "Q4_2", "Q4_3", "Q8_0",
                                 "Q8_1", "Q8_K"])
def test_row_functions_match_jax(fmt):
    """The per-format names quantize_row_<fmt> and dequantize_row_<fmt>
    (the JAX module's public functions): equal wire bytes and equal
    dequantised values."""
    jq = importlib.import_module("ggmlsharp_tpu.quant.quantize")
    tq = importlib.import_module("ggmlsharp_tpu_torch.quant.quantize")
    x = _inputs("zeros", (4, 512), seed=len(fmt))
    name = fmt.lower()
    jqt = getattr(jq, f"quantize_row_{name}")(jnp.asarray(x))
    qt = getattr(tq, f"quantize_row_{name}")(torch.from_numpy(x))
    assert qt.gtype == GType[fmt]
    assert to_wire(qt) == jax_wire(jqt)
    np.testing.assert_array_equal(
        getattr(tq, f"dequantize_row_{name}")(qt).numpy(),
        np.asarray(getattr(jq, f"dequantize_row_{name}")(jqt)))


@pytest.mark.parametrize("fmt", ["Q4_K", "Q6_K"])
@pytest.mark.parametrize("kind", ["normal", "ties", "shifted"])
def test_search_quantize_matches_jax_bit_exact(fmt, kind):
    """search=True (make_qkx2_quants / make_qx_quants-style): the candidate
    kept is an argmin over f32 sums, bit-equal because the sums run in the
    JAX package's (and ggml's) left-to-right order and the weights' square
    root is correctly rounded on both sides (_sqrt_rn)."""
    x = _inputs(kind, (4, 512), seed=3 + len(kind))
    jqt = jquantize(jnp.asarray(x), JGType[fmt], search=True)
    qt = quantize(torch.from_numpy(x), GType[fmt], search=True)
    assert to_wire(qt) == jax_wire(jqt)


def test_search_weight_root_is_correctly_rounded():
    """The search weights' root is the f32 rounding of the exact root, on
    values spread over the range the weights' mean squares take (PyTorch's
    vectorised CPU root is not, on some hosts)."""
    rng = np.random.default_rng(17)
    v = (10.0 ** rng.uniform(-12, 6, 4096)).astype(np.float32)
    want = np.sqrt(v.astype(np.float64)).astype(np.float32)
    got = _sqrt_rn(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sqrt(v))


@pytest.mark.parametrize("fmt", ["Q8_1", "Q8_K"])
def test_jit_scale_is_a_reciprocal_product(fmt):
    """The one divergence of the jitted reference on the f32-scale formats:
    its d is amax * f32(1/127), the port's (and ggml's, and eager JAX's)
    amax / 127; the quants agree."""
    x = _inputs("normal", (16, 512), seed=9)
    bs = 32 if fmt == "Q8_1" else 256
    amax = np.abs(x.reshape(16, -1, bs)).max(-1)
    jit = jax.jit(lambda a: jquantize(a, JGType[fmt]))(jnp.asarray(x))
    qt = quantize(torch.from_numpy(x), GType[fmt])
    np.testing.assert_array_equal(np.asarray(jit["d"]),
                                  amax * np.float32(1 / 127))
    np.testing.assert_array_equal(qt["d"].numpy(), amax / np.float32(127))
    eager = jquantize(jnp.asarray(x), JGType[fmt])
    np.testing.assert_array_equal(np.asarray(eager["d"]), qt["d"].numpy())


@pytest.mark.parametrize("name", ["q4_1", "q5_0", "q5_1"])
def test_golden_wire_bytes(gold, name):
    x = np.frombuffer(gold[f"{name}.input"], np.float32).reshape(ROWS, K)
    qt = quantize(torch.from_numpy(x.copy()), GType[name.upper()])
    assert to_wire(qt) == gold[f"{name}.wire"]


@pytest.mark.parametrize("name", ["q4_1", "q5_0", "q5_1", "q4_k", "q6_k"])
def test_golden_wire_dequant(gold, name):
    qt = from_wire(GType[name.upper()], gold[f"{name}.wire"], (ROWS, K),
                   device="cpu")
    want = np.frombuffer(gold[f"{name}.dequant"], np.float32).reshape(ROWS, K)
    np.testing.assert_array_equal(dequantize(qt).numpy(), want)


@pytest.mark.parametrize("name", ["q4_0", "q4_1", "q5_0", "q5_1", "q8_0",
                                  "q4_k", "q6_k"])
def test_golden_wire_round_trip(gold, name):
    """from_wire -> to_wire gives the oracle's bytes back, and the JAX
    package reads the same weights from them."""
    g = GType[name.upper()]
    qt = from_wire(g, gold[f"{name}.wire"], (ROWS, K), device="cpu")
    assert to_wire(qt) == gold[f"{name}.wire"]
    jqt = jax.tree.map(jnp.asarray,
                       qtensor_from_wire(JGType[name.upper()],
                                         gold[f"{name}.wire"], (ROWS, K)))
    np.testing.assert_array_equal(dequantize(qt).numpy(),
                                  np.asarray(jdequantize(jqt)))


@pytest.mark.parametrize("fmt", ALL)
def test_wire_round_trip_and_plane_shapes(fmt):
    g = GType[fmt]
    qt = quantize(torch.from_numpy(_inputs("normal", (2, 3, 512), 5)), g)
    wire = to_wire(qt)
    bs, bb = wire_block_bytes(g)
    assert len(wire) == 6 * 512 // bs * bb
    back = from_wire(g, wire, qt.shape, device="cpu")
    for key, (dtype, cols) in plane_specs(g, 512).items():
        assert qt[key].dtype == dtype and tuple(qt[key].shape) == (2, 3, cols)
        if not (g == GType.Q8_1 and key in ("d", "s")):  # f16 on the wire
            assert torch.equal(back[key], qt[key]), key
    assert set(back.planes) == set(qt.planes)
    assert qt.nbytes() == len(wire) + (6 * 512 // 32 * 4
                                       if g == GType.Q8_1 else 0)
    with pytest.raises(ValueError, match="does not match"):
        from_wire(g, wire[:-1], qt.shape, device="cpu")


@pytest.mark.parametrize("fmt", ["Q4_K", "Q6_K"])
def test_fused_scales_match_jax_kernel_dequant(fmt):
    """dequantize(fused_scales=True) is the JAX package's dequantization of
    the kernels' planes (its SWAR layout reads kd = f16(d·sc), km =
    f16(dmin·m)), bit for bit, and within 2^-11 of the exact scales."""
    x = _inputs("normal", (256, 512), seed=13)
    jqt = jquantize(jnp.asarray(x), JGType[fmt])
    qt = from_wire(GType[fmt], jax_wire(jqt), (256, 512), device="cpu")
    fused = dequantize(qt, fused_scales=True).numpy()
    np.testing.assert_array_equal(fused, np.asarray(jdequantize(to_swar(jqt))))
    exact = dequantize(qt).numpy()
    np.testing.assert_array_equal(exact, np.asarray(jdequantize(jqt)))
    assert not np.array_equal(fused, exact)
    np.testing.assert_allclose(fused, exact, rtol=0,
                               atol=2.0 ** -11 * 4 * np.abs(exact).max())


@pytest.mark.parametrize("fmt", WEIGHTS)
def test_get_rows_matches_jax(fmt):
    """Embedding rows dequantize exactly (the k-quants' exact scales too)."""
    x = _inputs("shifted", (4, 512), seed=21)
    jqt = jquantize(jnp.asarray(x), JGType[fmt])
    table = from_wire(GType[fmt], jax_wire(jqt), (4, 512), device="cpu")
    ids = np.array([[3, 0, 2], [1, 1, 3]], np.int32)
    got = get_rows(table, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jget_rows(jqt, jnp.asarray(ids))))


def test_registry_lists_every_format():
    reg = registry.registry()
    assert set(reg) == set(FORMATS)
    for g, entry in reg.items():
        assert entry.vec_dot_type == {
            GType.Q4_1: GType.Q8_1, GType.Q4_3: GType.Q8_1,
            GType.Q5_1: GType.Q8_1, GType.Q8_1: GType.Q8_1,
            GType.Q4_K: GType.Q8_K, GType.Q6_K: GType.Q8_K,
            GType.Q8_K: GType.Q8_K}.get(g, GType.Q8_0)
        assert entry.has_fused_matmul == (g.name in WEIGHTS)
        assert entry.has_int_dot == (g.name in ("Q4_0", "Q4_1", "Q5_0",
                                                "Q5_1", "Q8_0"))
    x = torch.from_numpy(_inputs("normal", (2, 256), 1))
    assert torch.equal(registry.get(GType.Q5_1).dequantize_row(
        registry.get(GType.Q5_1).quantize_row(x)),
        dequantize(quantize(x, GType.Q5_1)))
