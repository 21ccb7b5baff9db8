"""The formats slice end to end: the port's llama in every other weight
format against the JAX package on the CPU, on the small llama of
tests/test_torch_llama.py (n_embd 256, 2 layers, GQA 4/2, n_ff 512).

Weights cross as ggml wire bytes (``params_from_jax``; Q4_2/Q4_3, which have
no GGUF type, as ggml's blocks built from the JAX planes). The JAX reference
runs its forward on ``swar_params`` of the same tree: on the CPU its matmuls
then dequantize the k-quants with the fused f16 scales, the weights the
port's kernels and their plain versions use (the planar tree would use the
exact scales; the embedding stays planar and exact in both). Both packages
take a 12-token prompt and then 5 greedy steps, each fed the JAX argmax, and
every step's logits are compared (tests/test_torch_matmul_formats.py holds
every format at the kernels):

  * Q4_K and Q6_K over an INT8 flat cache (BASELINE config 3's cache; the
    prompt through flash over its fresh rows, every step through the decode
    attention over the int8 rows), Q8_K activations;
  * Q4_1, Q4_2, Q5_1 over the bf16 head-major cache;
  * the integer-dot route (GGML_TPU_INT_DOT=1) for Q4_1 and Q5_1 against
    the JAX forward's dequantize-then-matmul of the same function.

Tolerances, on logits of magnitude ~1: weight-only (GGML_TPU_QUANT_ACTS=0)
the packages differ in f32 summation order and libm ulps: 1e-4 over the bf16
cache (measured <= 2e-6); over the int8 cache a one-ulp difference can move
a K/V row's int8 rounding by a step: 2e-3 (measured <= 3e-4). With the
activation round trip an ulp can move a Q8 step: 2e-2, as in
tests/test_torch_llama.py (measured <= 9e-3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.config import get_config
from ggmlsharp_tpu.dtypes import GType as JGType
from ggmlsharp_tpu.io.gguf import qtensor_to_wire
from ggmlsharp_tpu.models import llama as jllama
from ggmlsharp_tpu.quant.formats import QTensor as JQTensor
from ggmlsharp_tpu.quant.formats import from_storage_order, unpack_nibbles
from ggmlsharp_tpu_torch import GType, quantize
from ggmlsharp_tpu_torch.kernels import config as kcfg
from ggmlsharp_tpu_torch.models import llama, sampling
from ggmlsharp_tpu_torch.quant.formats import QTensor, to_wire


@pytest.fixture(autouse=True)
def _port_mm_dot_f32(monkeypatch):
    """The port in mm_dot "f32", the function these tests hold against the
    JAX package: its matmuls multiply f32 operands exactly on the CPU in
    either of its modes (DEFAULT precision is f32 there). The port's "bf16"
    function is held against JAX in test_torch_mm_dot.py."""
    monkeypatch.setattr(kcfg, "_mm_dot", "f32")


CFG = dict(n_vocab=256, n_ctx=128, n_embd=256, n_head=4, n_head_kv=2,
           n_layer=2, n_ff=512)
PROMPT_LEN, STEPS = 12, 6


def _wire(jqt) -> bytes:
    if jqt.gtype not in (JGType.Q4_2, JGType.Q4_3):
        return qtensor_to_wire(jqt)[1]
    rows, nb = jqt.shape[0], jqt.shape[1] // 16
    v = np.asarray(from_storage_order(unpack_nibbles(jqt["qs"], jqt.shape[1]),
                                      16)).reshape(rows, nb, 16)
    parts = [np.asarray(jqt[p]).reshape(rows, nb, 1).view(np.uint8)
             for p in ("d", "m") if p in jqt.planes]
    parts.append((v[..., :8] | (v[..., 8:] << 4)).astype(np.uint8))
    return np.concatenate(parts, axis=-1).tobytes()


def to_port_tree(x):
    """JAX parameter tree -> numpy / (gtype, wire bytes, shape) leaves."""
    if isinstance(x, JQTensor):
        return (int(x.gtype), _wire(x), x.shape)
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: to_port_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [to_port_tree(v) for v in x]
    return np.asarray(x)


@pytest.fixture(scope="module")
def raw():
    jcfg = jllama.LlamaConfig(**CFG)
    return jcfg, jllama.init_params(jax.random.PRNGKey(5), jcfg)


_MODELS = {}


def _models(raw, fmt):
    """(JAX reference tree, port tree) for ``fmt``, made once. The JAX
    quantizers run under jit here, which is faster; the port reads whatever
    weights they give through the wire bytes."""
    if fmt not in _MODELS:
        jcfg, params = raw
        jq = jax.jit(lambda p: jllama.quantize_params(
            p, JGType[fmt], swar=False))(params)
        tq = llama.params_from_jax(to_port_tree(jq), device="cpu")
        if fmt in ("Q4_K", "Q6_K"):  # the legacy planes dequantize alike
            jq = jax.jit(jllama.swar_params)(jq)
        _MODELS[fmt] = (jq, tq)
    return _MODELS[fmt]


def _prompt():
    rng = np.random.default_rng(1)
    return rng.integers(0, CFG["n_vocab"], (1, PROMPT_LEN)).astype(np.int32)


def _steps(forward, params, cache, toks, to_in, argmax):
    """The prompt, then STEPS - 1 single-token calls; each step is fed
    ``toks[i]`` or, when toks is None, the previous row's argmax. Returns
    the tokens fed and each call's last logits row."""
    rows, fed = [], []
    lg, cache = forward(params, to_in(_prompt()), cache,
                        to_in(np.arange(PROMPT_LEN, dtype=np.int32)[None]))
    rows.append(np.asarray(lg[0, -1], np.float32))
    for i in range(STEPS - 1):
        t = argmax(rows[-1]) if toks is None else toks[i]
        fed.append(t)
        pos = np.array([[PROMPT_LEN + i]], np.int32)
        lg, cache = forward(params, to_in(np.array([[t]], np.int32)), cache,
                            to_in(pos))
        rows.append(np.asarray(lg[0, -1], np.float32))
    return fed, np.stack(rows)


_ROWS = {}


def _jax_rows(jcfg, jparams, fmt, int8, quant_acts):
    """JAX logits of the prompt and STEPS - 1 greedy steps, and the tokens
    fed (two compilations: the prompt's shape and a step's), once a
    setting: the integer-dot cases reuse their format's rows."""
    key = (fmt, int8, quant_acts)
    if key not in _ROWS:
        fwd = jax.jit(lambda p, t, c, pos: jllama.forward(
            p, jcfg, t, c, pos, prefix_bound=jcfg.n_ctx))
        _ROWS[key] = _steps(fwd, jparams, jllama.new_cache(jcfg, 1, int8=int8),
                            None, jnp.asarray, lambda r: int(np.argmax(r)))
    return _ROWS[key]


def _compare(raw, fmt, int8, quant_acts, monkeypatch, tol):
    jcfg, _ = raw
    jparams, tparams = _models(raw, fmt)
    monkeypatch.setattr(get_config(), "quantize_activations", quant_acts)
    monkeypatch.setenv("GGML_TPU_QUANT_ACTS", "1" if quant_acts else "0")
    toks, jrows = _jax_rows(jcfg, jparams, fmt, int8, quant_acts)
    tcfg = llama.LlamaConfig(**CFG)
    tcache = llama.new_cache(tcfg, 1, int8=int8, device="cpu")
    assert tcache.is_flat == int8

    def tfwd(p, t, c, pos):
        with torch.inference_mode():
            return llama.forward(p, tcfg, t, c, pos,
                                 prefix_bound=tcfg.n_ctx)

    _, trows = _steps(tfwd, tparams, tcache, toks, torch.from_numpy, None)
    np.testing.assert_allclose(trows, jrows, rtol=0, atol=tol)
    # the port's own greedy run: each token a JAX argmax up to tol
    gen, cache = sampling.generate(
        llama.forward, tcfg, tparams, torch.from_numpy(_prompt()),
        llama.new_cache(tcfg, 1, int8=int8, device="cpu"), STEPS)
    assert int(cache.length[0]) == PROMPT_LEN + STEPS
    for i, t in enumerate(gen[0].tolist()):
        assert jrows[i][t] >= jrows[i].max() - 2 * tol, f"token {i}"
        if i + 1 < STEPS and i < len(toks) and t != toks[i]:
            break
    return float(np.abs(trows - jrows).max())


@pytest.mark.parametrize("quant_acts,tol", [(False, 2e-3), (True, 2e-2)])
@pytest.mark.parametrize("fmt", ["Q4_K", "Q6_K"])
def test_kquants_int8_cache_match_jax(raw, monkeypatch, fmt, quant_acts,
                                      tol):
    _compare(raw, fmt, True, quant_acts, monkeypatch, tol)


@pytest.mark.parametrize("quant_acts,tol", [(False, 1e-4), (True, 2e-2)])
@pytest.mark.parametrize("fmt", ["Q4_1", "Q4_2", "Q5_1"])
def test_legacy_formats_head_major_match_jax(raw, monkeypatch, fmt,
                                             quant_acts, tol):
    _compare(raw, fmt, False, quant_acts, monkeypatch, tol)


@pytest.mark.parametrize("fmt", ["Q4_1", "Q5_1"])
def test_int_dot_route_matches_jax(raw, monkeypatch, fmt):
    """GGML_TPU_INT_DOT=1: every decode matmul of the port takes kernel B's
    route (its plain version here) and computes the function of the JAX
    forward's dequantize-then-matmul, up to f32 summation order."""
    from ggmlsharp_tpu_torch.kernels import matmul_q

    calls = []
    ref = matmul_q._int_dot_ref
    monkeypatch.setattr(matmul_q, "_int_dot_ref",
                        lambda *a: calls.append(1) or ref(*a))
    monkeypatch.setenv("GGML_TPU_INT_DOT", "1")
    _compare(raw, fmt, False, True, monkeypatch, 2e-2)
    # 4 matmuls a block in each single-token forward (the LM head keeps f32
    # x): the STEPS - 1 compared steps and generate's STEPS
    assert len(calls) == (2 * STEPS - 1) * 4 * CFG["n_layer"]


@pytest.mark.parametrize("fmt,embd", [("Q4_K", "Q6_K"), ("Q5_1", "Q8_0"),
                                      ("Q4_3", None)])
def test_quantize_params_matches_jax(fmt, embd):
    """The port's quantize_params lays the tree out as the JAX package's
    does (keys, fused rows, padded tables, each leaf's format and shape,
    read from jax.eval_shape: no compilation), and each leaf is the port's
    quantizer applied to the raw rows (bit-exact with the JAX quantizers,
    tests/test_torch_quant_formats.py)."""
    jcfg = jllama.LlamaConfig(**{**CFG, "n_vocab": 200, "n_layer": 1})
    params = jllama.init_params(jax.random.PRNGKey(6), jcfg)
    embd_g = None if embd is None else JGType[embd]
    jq = jax.eval_shape(lambda p: jllama.quantize_params(
        p, JGType[fmt], embd_gtype=embd_g, swar=False), params)
    raw_t = llama.params_from_jax(to_port_tree(params), device="cpu")
    tq = llama.quantize_params(raw_t, GType[fmt],
                               embd_gtype=None if embd is None
                               else GType[embd])

    def same(t, j):
        assert isinstance(t, QTensor) == isinstance(j, JQTensor)
        if isinstance(t, QTensor):
            assert (int(t.gtype), t.shape) == (int(j.gtype), tuple(j.shape))
        else:
            assert tuple(t.shape) == tuple(j.shape)

    for name in ("tok_embd", "output"):
        same(tq[name], jq[name])
        rows = raw_t[name].to(torch.float32)
        pad = rows.new_zeros((tq[name].shape[0] - rows.shape[0],
                              CFG["n_embd"]))
        assert to_wire(tq[name]) == to_wire(quantize(
            torch.cat([rows, pad]), GType[embd or fmt]))
    for jb, tb, rb in zip(jq["blocks"], tq["blocks"], raw_t["blocks"]):
        assert set(jb) == set(tb)
        for key, leaf in tb.items():
            same(leaf, jb[key])
        w = torch.cat([rb["w_gate"], rb["w_up"]]).to(torch.float32)
        assert to_wire(tb["w_gate_up"]) == to_wire(quantize(w, GType[fmt]))


def test_quantize_params_search_keeps_the_formats():
    """search=True reaches the k-quant search for the matmul weights and
    leaves the other formats' quantizers alone."""
    cfg = llama.LlamaConfig(**{**CFG, "n_layer": 1})
    raw_t = llama.init_params(cfg, device="cpu")
    plain = llama.quantize_params(raw_t, GType.Q4_K, embd_gtype=GType.Q8_0)
    srch = llama.quantize_params(raw_t, GType.Q4_K, embd_gtype=GType.Q8_0,
                                 search=True)
    w = raw_t["blocks"][0]["wo"].to(torch.float32)
    assert to_wire(srch["blocks"][0]["wo"]) == \
        to_wire(quantize(w, GType.Q4_K, search=True))
    assert to_wire(srch["blocks"][0]["wo"]) != \
        to_wire(plain["blocks"][0]["wo"])
    assert to_wire(srch["tok_embd"]) == to_wire(plain["tok_embd"])


@pytest.mark.parametrize("fmt", ["Q4_K", "Q6_K", "Q4_3"])
def test_synthetic_params(fmt):
    """synthetic_params draws the tree quantize_params gives (fused layout,
    padded tables, every matmul in the format) and it decodes."""
    cfg = llama.LlamaConfig(**CFG)
    p = llama.synthetic_params(cfg, GType[fmt], seed=1, device="cpu")
    ref = llama.quantize_params(llama.init_params(cfg, device="cpu"),
                                GType[fmt])
    assert p["tok_embd"].shape == ref["tok_embd"].shape
    for pb, rb in zip(p["blocks"], ref["blocks"]):
        assert {k: (tuple(v.shape), getattr(v, "gtype", None))
                for k, v in pb.items()} == \
            {k: (tuple(v.shape), getattr(v, "gtype", None))
             for k, v in rb.items()}
    again = llama.synthetic_params(cfg, GType[fmt], seed=1, device="cpu")
    assert to_wire(again["blocks"][1]["w_down"]) == \
        to_wire(p["blocks"][1]["w_down"])
    toks, _ = sampling.generate(llama.forward, cfg, p,
                                torch.tensor([[1, 2, 3]], dtype=torch.int32),
                                llama.new_cache(cfg, 1, int8=True,
                                                device="cpu"), 3)
    assert toks.shape == (1, 3)
