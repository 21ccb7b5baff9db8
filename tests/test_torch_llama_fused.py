"""The port's fused llama routes against the JAX package on the CPU: the
fused SwiGLU MLP (kernels.mlp_fused.flash_ff_silu_q4), the whole-block kernel
(kernels.llama_layer.llama_layer_step), the "attn" lane map of decode
attention (kernels.attn_decode.flash_decode_flat_attn), their gates, and the
slice end to end.

Inputs are made with numpy from a seed and handed to both packages. The JAX
functions run their Pallas kernels in interpret mode, as the JAX package's own
tests run them; the port's wrappers run their plain versions (CPU tensors).
The JAX kernels take TPU layouts (wire order x[:, sig], attn-space cache rows
k[:, a2e]); the tests permute on the JAX side and compare in element order.

Tolerances:
  * kernel 9 (two chained f32 products): the packages differ in f32
    summation order and libm ulps; the Q8_0 round trip of the input is bit
    equal on both sides. Measured 2e-6 on values up to 8: 5e-5;
  * kernel 10 (five chained products, rope, softmax): measured 3e-6 on y,
    1e-6 on k_new / v_new: 2e-4, the JAX package's own bar for k_new/v_new;
  * the attn lane map, JAX in its exact mode: 2e-5, as for the heads map;
  * whole model, weight-only: bf16 cache rows can round a one-ulp f32
    difference to a whole bf16 step. Measured 7e-7..3e-6 on logits of
    magnitude ~1.4: 2e-4, the GPT-2 slice's bar; with the Q8_0 activation
    round trip (routes that have one) an f32 input one ulp apart can move an
    activation by a whole Q8 step: measured 8e-3..1.1e-2 (the unfused route
    on the same model: 1.4e-2): 2e-2, the llama slice's bar. The model's
    weights have init_params' scale; at 2.5 times that scale the unfused
    route itself is 0.06 from the JAX package on logits up to 3.6.
The fused ``wo`` planes are compared bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.config import get_config
from ggmlsharp_tpu.dtypes import GType as JGType
from ggmlsharp_tpu.io.gguf import qtensor_to_wire
from ggmlsharp_tpu.kernels import config as jkcfg
from ggmlsharp_tpu.kernels import llama_layer as jll
from ggmlsharp_tpu.kernels import mlp_fused as jmf
from ggmlsharp_tpu.kernels.attn_decode import flash_decode_flat_attn as jattn
from ggmlsharp_tpu.models import llama as jllama
from ggmlsharp_tpu.models import sampling as jsampling
from ggmlsharp_tpu.quant.formats import QTensor as JQTensor
from ggmlsharp_tpu.quant.formats import swar_unpack_values, unpack_f16_pairs
from ggmlsharp_tpu.quant.quantize import quantize as jquantize
from ggmlsharp_tpu_torch import GType
from ggmlsharp_tpu_torch.kernels import attn_decode as ad
from ggmlsharp_tpu_torch.kernels import config as kcfg
from ggmlsharp_tpu_torch.kernels import llama_layer as ll
from ggmlsharp_tpu_torch.kernels import mlp_fused as mf
from ggmlsharp_tpu_torch.models import llama, sampling
from ggmlsharp_tpu_torch.models.common import params_from_jax
from ggmlsharp_tpu_torch.quant.formats import QTensor, from_wire


@pytest.fixture(autouse=True)
def _port_mm_dot_f32(monkeypatch):
    """The port in mm_dot "f32", the function these tests hold against the
    JAX package: its matmuls multiply f32 operands exactly on the CPU in
    either of its modes (DEFAULT precision is f32 there). The port's "bf16"
    function is held against JAX in test_torch_mm_dot.py."""
    monkeypatch.setattr(kcfg, "_mm_dot", "f32")


@pytest.fixture(autouse=True)
def _exact_jax_dots():
    """The JAX decode-attention kernel in its exact (f32) mode."""
    prev = jkcfg.mm_dot_mode()
    jkcfg.set_mm_dot("f32")
    yield
    jkcfg.set_mm_dot(prev)


def _cross(jq):
    """A JAX QTensor as the port's, through ggml wire bytes."""
    g, wire = qtensor_to_wire(jq)
    return from_wire(int(g), wire, jq.shape, device="cpu")


# --- kernel 9 ---------------------------------------------------------------

def _silu_pair(seed, e=256, f=256):
    rng = np.random.default_rng(seed)
    w1 = rng.standard_normal((2 * f, e)).astype(np.float32) * 0.1
    w2 = rng.standard_normal((e, f)).astype(np.float32) * 0.1
    return (jquantize(jnp.asarray(w1), JGType.Q4_0),
            jquantize(jnp.asarray(w2), JGType.Q4_0), rng)


def _mlp_silu_vs_jax(lead, quant_acts, E=256, F=256):
    q1, q2, rng = _silu_pair(21, E, F)
    assert jmf.mlp_silu_fuse_supported(q1, q2)
    w1, w2 = _cross(q1), _cross(q2)
    assert mf.mlp_silu_fuse_supported(w1, w2, int(np.prod(lead)))
    x = rng.standard_normal((*lead, E)).astype(np.float32)
    want = np.asarray(jmf.flash_ff_silu_q4(
        jmf.fuse_mlp_silu_q4(q1, q2), jnp.asarray(x),
        quantize_acts=quant_acts))
    got = mf.flash_ff_silu_q4(w1, w2, torch.from_numpy(x),
                              quantize_acts=quant_acts).numpy()
    assert got.shape == (*lead, E) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


@pytest.mark.parametrize("quant_acts", [False, True])
@pytest.mark.parametrize("lead", [(1,), (3,), (8,), (2, 3), (16,), (64,)])
def test_mlp_silu_matches_jax(lead, quant_acts):
    _mlp_silu_vs_jax(lead, quant_acts)


@pytest.mark.parametrize("quant_acts", [False, True])
def test_mlp_silu_short_chunks_matches_jax(quant_acts):
    """E 384, F 640: neither a multiple of the multi-row instance's
    256-column chunk, so both of its products end in a short chunk."""
    _mlp_silu_vs_jax((16,), quant_acts, 384, 640)


def test_mlp_silu_product_is_not_requantized():
    """The fused route differs from the unfused one by design: the gated
    product enters w_down as f32, not through the Q8_0 round trip."""
    from ggmlsharp_tpu_torch.ops import mul_mat_q, silu

    q1, q2, rng = _silu_pair(22)
    w1, w2 = _cross(q1), _cross(q2)
    x = torch.from_numpy(rng.standard_normal((4, 256)).astype(np.float32))
    fused = mf.flash_ff_silu_q4(w1, w2, x, quantize_acts=True)
    gu = mul_mat_q(w1, x)
    unfused = mul_mat_q(w2, silu(gu[:, :256]) * gu[:, 256:])
    diff = float((fused - unfused).abs().max())
    assert 1e-4 < diff < 0.2  # a Q8_0 rounding of h, not a wrong product


def _gate_qt(cls, gtype, n, k):
    """A QTensor of the right type and shape for a gate (planes unread)."""
    return cls(gtype, (n, k), {"qs": None, "d": None})


@pytest.mark.parametrize("E,F", [(256, 256), (256, 704), (128, 64),
                                 (256, 96), (192, 256), (384, 640),
                                 (1024, 2816), (2048, 5632)])
@pytest.mark.parametrize("rows", [None, 1, 64, 65])
def test_mlp_silu_gate_matches_jax(E, F, rows):
    want = jmf.mlp_silu_fuse_supported(
        _gate_qt(JQTensor, JGType.Q4_0, 2 * F, E),
        _gate_qt(JQTensor, JGType.Q4_0, E, F), rows)
    got = mf.mlp_silu_fuse_supported(
        _gate_qt(QTensor, GType.Q4_0, 2 * F, E),
        _gate_qt(QTensor, GType.Q4_0, E, F), rows)
    assert got == want


def test_mlp_silu_gate_types_and_the_tile_clause():
    q4 = _gate_qt(QTensor, GType.Q4_0, 512, 256)
    dn = _gate_qt(QTensor, GType.Q4_0, 256, 256)
    assert mf.mlp_silu_fuse_supported(q4, dn)
    assert not mf.mlp_silu_fuse_supported(  # n1 != 2 * k2
        q4, _gate_qt(QTensor, GType.Q4_0, 256, 128))
    assert not mf.mlp_silu_fuse_supported(
        _gate_qt(QTensor, GType.Q8_0, 512, 256), dn)
    assert not mf.mlp_silu_fuse_supported(torch.zeros(512, 256), dn)
    # the one clause of the JAX gate the port leaves out: the JAX package's
    # limit on a weight tile in the TPU's on-chip memory turns its route off
    # at Llama-7B's F (down's 11008-long rows), where the port's runs
    e, f = 4096, 11008
    assert not jmf.mlp_silu_fuse_supported(
        _gate_qt(JQTensor, JGType.Q4_0, 2 * f, e),
        _gate_qt(JQTensor, JGType.Q4_0, e, f))
    assert mf.mlp_silu_fuse_supported(
        _gate_qt(QTensor, GType.Q4_0, 2 * f, e),
        _gate_qt(QTensor, GType.Q4_0, e, f))


# --- kernel 10 --------------------------------------------------------------

def _cfgs(E, H, Hkv, F, mode=0, **kw):
    args = dict(n_vocab=256, n_ctx=64, n_embd=E, n_head=H, n_head_kv=Hkv,
                n_layer=1, n_ff=F, rope_mode=mode, **kw)
    return jllama.LlamaConfig(**args), llama.LlamaConfig(**args)


def _raw_block(rng, E, Ekv, F):
    r = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.1
    return {"attn_norm": 1.0 + 0.1 * r(E), "ffn_norm": 1.0 + 0.1 * r(E),
            "wq": r(E, E), "wk": r(Ekv, E), "wv": r(Ekv, E), "wo": r(E, E),
            "w_gate": r(F, E), "w_up": r(F, E), "w_down": r(E, F)}


def _layer_case(E, H, Hkv, F, mode, T, npast, seed, cache="f32"):
    """(JAX result in element order, port result) of one block call on the
    same numpy inputs; the cache rows are given in element order."""
    jcfg, tcfg = _cfgs(E, H, Hkv, F, mode)
    D = E // H
    Ekv = Hkv * D
    rng = np.random.default_rng(seed)
    raw = _raw_block(rng, E, Ekv, F)
    x = rng.standard_normal((1, E)).astype(np.float32) * 0.5
    kc = rng.standard_normal((T, Ekv)).astype(np.float32) * 0.3
    vc = rng.standard_normal((T, Ekv)).astype(np.float32) * 0.3
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if cache == "bf16" \
        else (jnp.float32, torch.float32)

    assert jll.llama_layer_fuse_supported(jcfg)
    sig = jmf.q4_korder_perm(E)
    a2e = jll.a2e_map(Ekv, D, mode)
    fused = jll.fuse_llama_layer({k: jnp.asarray(v) for k, v in raw.items()},
                                 jcfg)
    y, kn, vn = jll.llama_layer_step(
        fused, jnp.asarray(x[:, sig]), jnp.asarray(kc[:, a2e]).astype(jdt),
        jnp.asarray(vc[:, a2e]).astype(jdt), jnp.int32(npast), jcfg)
    inv, inva = np.argsort(sig), np.argsort(a2e)
    want = (np.asarray(y)[:, inv], np.asarray(kn)[:, inva],
            np.asarray(vn)[:, inva])

    assert ll.llama_layer_fuse_supported(tcfg)
    blk = {"layer_fused": ll.fuse_llama_layer(
        {k: torch.from_numpy(v) for k, v in raw.items()}, tcfg)}
    got = ll.llama_layer_step(
        blk, torch.from_numpy(x), torch.from_numpy(kc).to(tdt),
        torch.from_numpy(vc).to(tdt), torch.tensor([npast], dtype=torch.int32),
        tcfg)
    return want, [g.numpy() for g in got]


@pytest.mark.parametrize("mode", [0, 2])
@pytest.mark.parametrize("T,npast,cache", [(64, 5, "f32"), (64, 0, "f32"),
                                           (64, 63, "bf16")])
def test_llama_layer_matches_jax(mode, T, npast, cache):
    want, got = _layer_case(256, 4, 4, 704, mode, T, npast,
                            mode * 10 + T + npast, cache)
    for g, w, name in zip(got, want, ("y", "k_new", "v_new")):
        assert g.shape == w.shape and g.dtype == np.float32, name
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4, err_msg=name)


def test_llama_layer_matches_jax_gqa():
    """GQA, n_rep 4, D 128 (tests/test_llama_layer.py:182)."""
    want, got = _layer_case(1024, 8, 2, 704, 0, 64, 9, 33)
    for g, w, name in zip(got, want, ("y", "k_new", "v_new")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4, err_msg=name)


def test_llama_layer_npast_past_the_view_attends_every_row():
    """npast >= T: all T rows and the fresh one, the answer of a one-row
    longer view at npast T whose stale row T is masked."""
    _, tcfg = _cfgs(256, 4, 4, 512)
    rng = np.random.default_rng(3)
    blk = {"layer_fused": ll.fuse_llama_layer(
        {k: torch.from_numpy(v)
         for k, v in _raw_block(rng, 256, 256, 512).items()}, tcfg)}
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    x, kc, vc = f(1, 256), f(17, 256), f(17, 256)
    out = ll.llama_layer_step(blk, x, kc[:16], vc[:16], torch.tensor([20]),
                              tcfg, ll.rope_vectors(torch.tensor([16]), tcfg))
    want = ll.llama_layer_step(blk, x, kc, vc, torch.tensor([16]), tcfg)
    for o, w in zip(out, want):  # 16 or 17 terms a sum, values up to 4
        torch.testing.assert_close(o, w, rtol=1e-5, atol=1e-5)


def _jax_wo(fused, E):
    """The JAX planes of the fused wo as nibble values [E, E] and f16 scale
    bits [E, E/32], both in the matrix's own row order (the row permutation
    of the planes undone)."""
    inv = np.argsort(jmf.q4_korder_perm(E))
    vals = np.asarray(swar_unpack_values(fused["qs_o"], E, E))[inv]
    d = np.asarray(unpack_f16_pairs(fused["d_o"].T, E // 32))[inv]
    return vals, d.view(np.uint16)


def _port_wo(fused):
    w = fused["wo"]
    n, k = w.shape
    qs = w["qs"].numpy().reshape(n, k // 32, 16)
    vals = np.concatenate([qs & 0xF, qs >> 4], axis=-1).reshape(n, k)
    return vals.astype(np.int32), w["d"].numpy().view(np.uint16)


@pytest.mark.parametrize("prequantized", [False, True])
@pytest.mark.parametrize("E,H,Hkv,mode", [(256, 4, 4, 0), (256, 4, 4, 2),
                                          (1024, 8, 2, 0)])
def test_fused_wo_bit_equal(E, H, Hkv, mode, prequantized):
    """The block route's wo is a different matrix from the model's: columns
    regrouped, then quantized. The port's copy equals the JAX planes bit for
    bit, from f32 weights and from a Q4_0 wo (dequantized first)."""
    jcfg, tcfg = _cfgs(E, H, Hkv, 512, mode)
    rng = np.random.default_rng(E + mode)
    raw = _raw_block(rng, E, Hkv * (E // H), 512)
    jblk = {k: jnp.asarray(v) for k, v in raw.items()}
    tblk = {k: torch.from_numpy(v) for k, v in raw.items()}
    if prequantized:
        for k, v in raw.items():
            if v.ndim == 2:
                jblk[k] = jquantize(jnp.asarray(v), JGType.Q4_0)
                tblk[k] = _cross(jblk[k])
    jf = jll.fuse_llama_layer(jblk, jcfg)
    tf = ll.fuse_llama_layer(tblk, tcfg)
    jv, jd = _jax_wo(jf, E)
    tv, td = _port_wo(tf)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(td, jd)
    # and it is not the model's wo with its columns moved: its blocks hold
    # other elements, so scales and roundings differ
    std, _ = _port_wo({"wo": ll.quantize(torch.from_numpy(raw["wo"]),
                                         GType.Q4_0)})
    assert (std[:, ll.wo_colperm(tcfg)] != tv).any()
    # the index helpers are the JAX package's
    np.testing.assert_array_equal(ll.q4_korder_perm(E), jmf.q4_korder_perm(E))
    np.testing.assert_array_equal(ll.a2e_map(E, E // H, mode),
                                  jll.a2e_map(E, E // H, mode))
    np.testing.assert_array_equal(
        tf["slot"].numpy(), np.argsort(ll.wo_colperm(tcfg)))
    if prequantized:  # shared, not copied
        assert tf["w_down"] is tblk["w_down"]


@pytest.mark.parametrize("E,H,Hkv,F", [
    (256, 4, 4, 704), (256, 4, 2, 512), (1024, 8, 2, 704), (512, 8, 8, 1376),
    (256, 4, 4, 96), (384, 6, 6, 1024), (4096, 32, 32, 11008),
    (4096, 32, 8, 14336), (2048, 32, 4, 5632), (256, 3, 1, 512)])
def test_llama_layer_gate_matches_jax(E, H, Hkv, F):
    jcfg, tcfg = _cfgs(E, H, Hkv, F)
    assert ll.llama_layer_fuse_supported(tcfg) == \
        jll.llama_layer_fuse_supported(jcfg)


# --- kernel 3, the "attn" lane map -------------------------------------------

@pytest.mark.parametrize("B,Hq,Hkv,D,T,npasts", [
    (1, 4, 4, 64, 64, [5]), (2, 8, 2, 128, 64, [0, 63]),
    (3, 4, 2, 64, 128, [99, 127, 1])])
def test_decode_attn_layout_matches_jax(B, Hq, Hkv, D, T, npasts):
    """Random rows handed to both packages as they are, in the attn map."""
    rng = np.random.default_rng(Hq * 100 + T + B)
    E, Ekv = Hq * D, Hkv * D
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, kn, vn, kc, vc = f(B, E), f(B, Ekv), f(B, Ekv), f(B, T, Ekv), \
        f(B, T, Ekv)
    npast = np.asarray(npasts, np.int32)
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    want = np.asarray(jattn(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                            jb(kc), jb(vc), jnp.asarray(npast), Hq, Hkv, D))
    got = ad.flash_decode_flat_attn(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        tb(kc), tb(vc), torch.from_numpy(npast), Hq, Hkv, D).numpy()
    assert got.shape == (B, E) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_decode_attn_layout_is_the_heads_map_permuted():
    """The attn map only moves lanes: permuting rows to element order, the
    heads-map function and permuting back gives the same numbers."""
    B, Hq, Hkv, D, T = 2, 8, 2, 64, 32
    rng = np.random.default_rng(8)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    a2e = torch.from_numpy(ll.a2e_map(Hkv * D, D, 0))  # the rope-pair order
    n_rep = Hq // Hkv
    a2e_q = torch.cat([(a2e // D * n_rep + r) * D + a2e % D
                       for r in range(n_rep)])
    q, kn, vn = f(B, Hq * D), f(B, Hkv * D), f(B, Hkv * D)
    kc, vc = f(B, T, Hkv * D).bfloat16(), f(B, T, Hkv * D).bfloat16()
    npast = torch.tensor([7, 31])
    want = ad.flash_decode_flat(q.reshape(B, Hq, D), kn, vn, kc, vc, npast,
                                Hkv, D).reshape(B, Hq * D)
    got = ad.flash_decode_flat_attn(q[:, a2e_q], kn[:, a2e], vn[:, a2e],
                                    kc[..., a2e], vc[..., a2e], npast, Hq,
                                    Hkv, D)
    torch.testing.assert_close(got, want[:, a2e_q], rtol=1e-6, atol=1e-6)
    with pytest.raises(TypeError, match="bf16"):
        ad.flash_decode_flat_attn(q, kn, vn, kc.float(), vc.float(), npast,
                                  Hq, Hkv, D)


# --- the slice end to end ----------------------------------------------------

E2E = dict(n_vocab=256, n_ctx=64, n_embd=256, n_head=4, n_head_kv=4,
           n_layer=2, n_ff=512)
PROMPT = np.asarray([[7, 3, 99, 12]], np.int32)
N_STEPS = 4


def _raw_model(seed):
    rng = np.random.default_rng(seed)
    E, F, V = E2E["n_embd"], E2E["n_ff"], E2E["n_vocab"]
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    w = lambda *s: bf(rng.standard_normal(s).astype(np.float32) * 0.02)
    # gains that are powers of two: under jit XLA may keep excess precision
    # across the norm's bf16 ops (no rounding before the multiply by g);
    # with such gains the product is the same either way
    g = lambda: bf(rng.choice([0.5, 1.0, 2.0], E).astype(np.float32))
    return {"tok_embd": w(V, E), "norm": g(), "output": w(V, E),
            "blocks": [{"attn_norm": g(), "wq": w(E, E), "wk": w(E, E),
                        "wv": w(E, E), "wo": w(E, E), "ffn_norm": g(),
                        "w_gate": w(F, E), "w_up": w(F, E), "w_down": w(E, F)}
                       for _ in range(E2E["n_layer"])]}


def _tree_to_numpy(x):
    if isinstance(x, dict):
        return {k: _tree_to_numpy(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_tree_to_numpy(v) for v in x]
    return np.asarray(x)


def _feed(prefill, step, params, cache, as_tensor, bucket):
    """Prefill PROMPT, then N_STEPS steps fed fixed tokens: the logits of
    every call, [1 + N_STEPS, V]."""
    toks = np.asarray([[5], [17], [200], [64]], np.int32)
    lg, cache = prefill(params, as_tensor(PROMPT), cache, t_eff=bucket)
    rows = [np.asarray(lg)[0]]
    for i in range(N_STEPS):
        lg, cache = step(params, as_tensor(toks[i:i + 1]), cache,
                         t_eff=bucket)
        rows.append(np.asarray(lg)[0])
    return np.stack(rows)


@pytest.mark.parametrize("quant_acts,tol", [(False, 2e-4), (True, 2e-2)])
@pytest.mark.parametrize("case", ["mlp_fused", "both_flat_float",
                                  "both_int8"])
def test_slice_matches_jax(monkeypatch, case, quant_acts, tol):
    """(a) MLP_FUSED alone over the head-major cache; (b) both switches over
    a flat bf16 cache: the prefill on the per-op loop, every decode step
    through the block route; (c) both switches over an INT8 cache: the block
    route is skipped, the fused MLP runs."""
    layer = case != "mlp_fused"
    monkeypatch.setenv("GGML_TPU_MLP_FUSED", "1")
    monkeypatch.setenv("GGML_TPU_LLAMA_FUSED", "1" if layer else "0")
    monkeypatch.setattr(get_config(), "quantize_activations", quant_acts)
    monkeypatch.setenv("GGML_TPU_QUANT_ACTS", "1" if quant_acts else "0")
    cache_kw = {"mlp_fused": {}, "both_flat_float": {"flat": True},
                "both_int8": {"int8": True}}[case]
    raw = _raw_model(4)

    jcfg = jllama.LlamaConfig(**E2E)
    jq = jllama.quantize_params(raw, JGType.Q4_0, cfg=jcfg)
    assert all("mlp_fused" in b for b in jq["blocks"])
    assert all(("layer_fused" in b) == layer for b in jq["blocks"])
    jpre, jstep = jsampling.make_decode_fns(jllama.forward, jcfg)
    want = _feed(jpre, jstep, jq, jllama.new_cache(jcfg, 1, **cache_kw),
                 jnp.asarray, 64)

    tcfg = llama.LlamaConfig(**E2E)
    # the switches come from the environment here, as on the JAX side
    tq = llama.quantize_params(
        params_from_jax(_tree_to_numpy(raw), device="cpu"), GType.Q4_0,
        cfg=tcfg)
    assert all("mlp_fused" in b for b in tq["blocks"])
    assert all(("layer_fused" in b) == layer for b in tq["blocks"])
    tpre, tstep = sampling.make_decode_fns(llama.forward, tcfg)
    cache = llama.new_cache(tcfg, 1, device="cpu", **cache_kw)
    assert cache.is_flat == (case != "mlp_fused")
    with torch.inference_mode():
        got = _feed(tpre, tstep, tq, cache, torch.from_numpy, 64)
    assert np.isfinite(got).all() and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_routes_are_off_by_default_and_differ_by_design(monkeypatch):
    monkeypatch.delenv("GGML_TPU_MLP_FUSED", raising=False)
    monkeypatch.delenv("GGML_TPU_LLAMA_FUSED", raising=False)
    monkeypatch.setenv("GGML_TPU_QUANT_ACTS", "1")
    tcfg = llama.LlamaConfig(**E2E)
    raw = params_from_jax(_tree_to_numpy(_raw_model(4)), device="cpu")
    off = llama.quantize_params(raw, GType.Q4_0, cfg=tcfg)
    assert not any("mlp_fused" in b or "layer_fused" in b
                   for b in off["blocks"])
    on = llama.quantize_params(raw, GType.Q4_0, cfg=tcfg, mlp_fused=True,
                               layer_fused=True)
    no_cfg = llama.quantize_params(raw, GType.Q4_0, layer_fused=True)
    assert not any("layer_fused" in b for b in no_cfg["blocks"])
    q8 = llama.quantize_params(raw, GType.Q8_0, cfg=tcfg, mlp_fused=True,
                               layer_fused=True)
    assert not any("mlp_fused" in b or "layer_fused" in b
                   for b in q8["blocks"])
    for a, b in zip(on["blocks"], off["blocks"]):  # one copy of the payload
        assert a["layer_fused"]["wqkv"] is a["wqkv"]
        assert torch.equal(a["wo"]["qs"], b["wo"]["qs"])

    def logits(p):
        pre, step = sampling.make_decode_fns(llama.forward, tcfg)
        with torch.inference_mode():
            return _feed(pre, step, p, llama.new_cache(tcfg, 1, flat=True,
                                                       device="cpu"),
                         torch.from_numpy, 64)

    a, b = logits(on), logits(off)
    diff = np.abs(a - b).max(axis=1)
    assert diff[0] > 1e-5        # prefill: the fused MLP's f32 gated product
    assert 1e-4 < diff[1:].max() < 0.5  # decode: no round trip, another wo
    for ra, rb in zip(a, b):  # the same model still: the JAX tests' bar
        assert np.corrcoef(ra, rb)[0, 1] > 0.98


def test_params_from_jax_refuses_tpu_plane_copies():
    tree = {"blocks": [{"wo": np.zeros((2, 2), np.float32),
                        "layer_fused": {"qs_o": np.zeros(2, np.uint32)}}]}
    with pytest.raises(ValueError, match="layer_fused"):
        params_from_jax(tree, device="cpu")


def test_synthetic_params_with_the_routes_on():
    """The chip run's random tree: the same weights with the switches on or
    off, the block route's wo copies drawn after them."""
    tcfg = llama.LlamaConfig(**E2E)
    off = llama.synthetic_q4_0_params(tcfg, seed=1, device="cpu",
                                      mlp_fused=False, layer_fused=False)
    on = llama.synthetic_q4_0_params(tcfg, seed=1, device="cpu",
                                     mlp_fused=True, layer_fused=True)
    for a, b in zip(on["blocks"], off["blocks"]):
        assert set(a) - set(b) == {"mlp_fused", "layer_fused"}
        for key in ("wqkv", "wo", "w_gate_up", "w_down"):
            assert torch.equal(a[key]["qs"], b[key]["qs"]), key
        lf = a["layer_fused"]
        assert lf["wo"].shape == (256, 256) and lf["w_down"] is a["w_down"]
        assert sorted(lf["slot"].tolist()) == list(range(256))
    toks, cache = sampling.generate(
        llama.forward, tcfg, on, torch.from_numpy(PROMPT),
        llama.new_cache(tcfg, 1, flat=True, device="cpu"), 3)
    assert toks.shape == (1, 3) and int(cache.length[0]) == 7
