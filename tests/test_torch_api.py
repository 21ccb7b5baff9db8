"""Public names the port shares with the JAX package, held against it:

  * the type helpers ``type_name``, ``block_size``, ``type_size`` and
    ``is_quantized`` (package level, as ``ggmlsharp_tpu/__init__.py``
    exports them), for every GType;
  * ``models.KVCache`` / ``models.init_cache``, re-exported as the JAX
    package's ``models/__init__.py`` does;
  * the debug checks ``utils.checked`` / ``utils.check`` (raising, with the
    message JAX's checkify gives, where JAX's do) and
    ``utils.assert_all_finite`` (FloatingPointError naming every
    non-finite leaf by its path, as JAX's does);
  * ``models.gpt2.quantize_params(search=...)``: the same wire bytes as the
    JAX package's with the same search flag.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ggmlsharp_tpu as jgg
from ggmlsharp_tpu.io.gguf import qtensor_to_wire
from ggmlsharp_tpu.models import gpt2 as jgpt2
from ggmlsharp_tpu.quant.formats import QTensor as JQTensor
from ggmlsharp_tpu.utils import debug as jdebug
import ggmlsharp_tpu_torch as gg
from ggmlsharp_tpu_torch.models import gpt2
from ggmlsharp_tpu_torch.quant.formats import QTensor, to_wire
from ggmlsharp_tpu_torch.utils import debug


@pytest.mark.parametrize("name", [t.name for t in gg.GType])
def test_type_helpers_match_jax(name):
    t, jt = gg.GType[name], jgg.GType[name]
    assert int(t) == int(jt)
    assert gg.type_name(t) == jgg.type_name(jt)
    assert gg.block_size(t) == jgg.block_size(jt)
    assert gg.type_size(t) == jgg.type_size(jt)
    assert gg.is_quantized(t) is jgg.is_quantized(jt)


def test_type_helpers_cover_jax_types_and_exports():
    assert [t.name for t in gg.GType] == [t.name for t in jgg.GType]
    for fn in ("type_name", "block_size", "type_size", "is_quantized"):
        assert fn in gg.__all__ and fn in jgg.__all__


def test_models_reexport_kv_cache():
    from ggmlsharp_tpu_torch import models
    from ggmlsharp_tpu_torch.models import kv_cache

    assert models.KVCache is kv_cache.KVCache
    assert models.init_cache is kv_cache.init_cache
    assert {"KVCache", "init_cache"} <= set(models.__all__)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("flat", [False, True])
def test_kv_cache_is_flat_matches_jax(flat, int8):
    """kv_cache.is_flat(cache), the JAX module function the models call,
    on both layouts and both storage types."""
    from ggmlsharp_tpu.models import kv_cache as jkvc
    from ggmlsharp_tpu_torch.models import kv_cache as kvc

    jc = jkvc.init_cache(2, 1, 2, 16, 64, int8=int8, flat=flat)
    tc = kvc.init_cache(2, 1, 2, 16, 64, int8=int8, flat=flat, device="cpu")
    assert kvc.is_flat(tc) is jkvc.is_flat(jc) is flat
    assert tc.is_flat is flat


def _fn(check, lib):
    """The same function written against either package: two checks, the
    first formatted with two values."""
    def f(x):
        check(lib.all(x > 0), "x must be positive, got min {m}, max {n}",
              m=lib.min(x), n=lib.max(x))
        check(lib.sum(x) < 100, "sum too big")
        return x * 2
    return f


@pytest.mark.parametrize("values", [[1.0, 2.0, 3.0], [-1.0, 2.0, 3.0],
                                    [50.0, 60.0, 1.0], [-50.0, 60.0, 100.0]])
def test_checked_raises_where_checkify_does(values):
    """The same outcome and message as checkify: the first failed check,
    formatted, after the call; a passing call returns fn's result."""
    jf = jdebug.checked(_fn(jdebug.check, jnp))
    tf = debug.checked(_fn(debug.check, torch))
    try:
        want = np.asarray(jf(jnp.asarray(values, jnp.float32)))
        jerr = None
    except ValueError as e:
        jerr = str(e)
    if jerr is None:
        got = tf(torch.tensor(values))
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        with pytest.raises(ValueError) as info:
            tf(torch.tensor(values))
        assert str(info.value) == jerr
        assert isinstance(info.value, debug.CheckError)


def test_check_outside_checked_raises_at_once():
    with pytest.raises(ValueError) as jinfo:
        jdebug.check(jnp.asarray(False), "outside {v}", v=jnp.float32(2.5))
    with pytest.raises(ValueError) as info:
        debug.check(torch.tensor(False), "outside {v}", v=torch.tensor(2.5))
    assert str(info.value) == str(jinfo.value)
    debug.check(torch.tensor(True), "never")  # a true check is silent


def test_checked_records_without_reading_inside():
    """A check inside the call does not read its predicate there: the
    call's later work runs before the wrapper raises."""
    ran = []

    def f(x):
        debug.check(x.sum() < 0, "negative {s}", s=x.sum())
        ran.append(True)
        return x

    with pytest.raises(debug.CheckError, match="negative 3.0"):
        debug.checked(f)(torch.ones(3))
    assert ran == [True]


def _tree(lib, nan, inf):
    return {"a": lib.ones(2), "b": [lib.asarray([1.0, nan]), None],
            "c": lib.arange(3), "d": {"e": lib.asarray([inf, 0.0])}}


@pytest.mark.parametrize("nan,inf", [(float("nan"), float("inf")),
                                     (1.0, float("-inf")), (float("nan"), 2.0),
                                     (1.0, 2.0)])
def test_assert_all_finite_names_the_leaves(nan, inf):
    jt = _tree(jnp, nan, inf)
    tt = {"a": torch.ones(2), "b": [torch.tensor([1.0, nan]), None],
          "c": torch.arange(3), "d": {"e": torch.tensor([inf, 0.0])}}
    try:
        want = jdebug.assert_all_finite(jt, name="params")
    except FloatingPointError as e:
        with pytest.raises(FloatingPointError) as info:
            debug.assert_all_finite(tt, name="params")
        assert str(info.value) == str(e)
    else:
        assert debug.assert_all_finite(tt, name="params") is want is True


def test_assert_all_finite_sweeps_quantized_leaves():
    """A QTensor's planes are leaves too (its f16 scales can overflow)."""
    qt = gg.quantize(torch.ones((2, 32)), gg.GType.Q8_0)
    qt.planes["d"] = torch.tensor([[float("inf")], [1.0]],
                                  dtype=torch.float16)
    with pytest.raises(FloatingPointError, match=r"\['w'\]\['d'\]"):
        debug.assert_all_finite({"w": qt})


def _port_tree(x):
    if isinstance(x, JQTensor):
        g, wire = qtensor_to_wire(x)
        return (int(g), wire, x.shape)
    if isinstance(x, dict):
        return {k: _port_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_port_tree(v) for v in x]
    return np.asarray(x)


def _quantized_wires(tree, path=""):
    """(path, wire bytes) of every quantized leaf, in tree order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _quantized_wires(v, f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _quantized_wires(v, f"{path}[{i}]")
    elif isinstance(tree, JQTensor):
        yield path, qtensor_to_wire(tree)[1]
    elif isinstance(tree, QTensor):
        yield path, to_wire(tree)


@pytest.fixture(scope="module")
def gpt2_raw():
    cfg = jgpt2.GPT2Config(n_vocab=300, n_ctx=32, n_embd=256, n_head=4,
                           n_layer=1)
    raw = jgpt2.init_params(jax.random.PRNGKey(5), cfg, dtype=jnp.float32)
    return raw, gpt2.params_from_jax(_port_tree(raw), device="cpu")


@pytest.mark.parametrize("search", [False, True])
def test_gpt2_quantize_params_search_matches_jax(gpt2_raw, search):
    """Q4_K's scale search on or off: the same wire bytes in every
    quantized leaf (the JAX tree in row layout and unpadded, the port's
    layout), and the flag changes what is chosen."""
    raw, raw_t = gpt2_raw
    jq = jgpt2.quantize_params(raw, jgg.GType.Q4_K, pad_rows_to=1,
                               search=search, swar=False)
    tq = gpt2.quantize_params(raw_t, gg.GType.Q4_K, search=search)
    want, got = list(_quantized_wires(jq)), list(_quantized_wires(tq))
    assert [p for p, _ in got] == [p for p, _ in want] and len(got) == 5
    for (path, g), (_, w) in zip(got, want):
        assert g == w, path
    other = gpt2.quantize_params(raw_t, gg.GType.Q4_K, search=not search)
    assert any(g != o for (_, g), (_, o) in
               zip(got, _quantized_wires(other)))
