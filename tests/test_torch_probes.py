"""The tuning path's probes (ggmlsharp_tpu_torch/probes/) against the TPU
probe scripts they replace, on the CPU, through the plain versions:

  * scripts/probe_swar.py: its ``swar_mm`` (interpret mode) on its own
    check inputs (N 512, K 1024, b 8) against the port's K-major plain
    matvec, packed by the script's ``pack_plane`` / ``perms`` and by the
    port's ``kmajor_repack``; its ``probe_bitcast_order`` against the plain
    byte map. Tolerance of the matvec: both sum K f32 products in other
    orders, so 1e-5 of sum |x|·|w| (kernel 1's bar; measured ~1e-7).
  * scripts/diag_chunked10.py: its f16-pair decode kernel (:42, rebuilt
    here from the JAX package's ``_decode_f16x2_arr``, interpret mode) over
    all 65,536 patterns against the plain decode, bit for bit on the finite
    ones (+0 = -0, the script's rule).
  * scripts/probe_dq_variants.py: its ``mm`` passes no interpret flag and
    cannot run on the CPU; the plain Q4_0 version is held against the
    script's own arithmetic, x @ ((q - 8)·d), in numpy (1e-5 of the sum).
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu_torch import GType
from ggmlsharp_tpu_torch.ops.matmul import mul_mat_q
from ggmlsharp_tpu_torch.probes import dq_variants, q8_acts, scale_decode, swar
from ggmlsharp_tpu_torch.quant.formats import QTensor
from ggmlsharp_tpu_torch.quant.quantize import _pack_nibbles, int_values

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def probe_swar():
    """scripts/probe_swar.py as a module (it sets a JAX cache directory if
    none is set; that is put back)."""
    before = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    spec = importlib.util.spec_from_file_location(
        "probe_swar_script", os.path.join(ROOT, "scripts", "probe_swar.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if before is None:
        os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    return mod


def _q4_0(V, D):
    """A Q4_0 QTensor [n, k] from values V (k, n) in 0..15 and f16-exact
    scales D (k/32, n)."""
    k, n = V.shape
    q = torch.from_numpy(V.T.astype(np.int64).copy())
    qs = _pack_nibbles(q.reshape(n, k // 32, 32))
    d = torch.from_numpy(D.T.astype(np.float16).copy())
    return QTensor(GType.Q4_0, (n, k), {"qs": qs, "d": d})


@pytest.mark.parametrize("n,k", [(64, 256), (36, 1024), (8, 11008)])
def test_kmajor_repack_round_trips(n, k):
    from ggmlsharp_tpu_torch.models.llama import random_q4_0

    w = random_q4_0(n, k, torch.Generator().manual_seed(n), "cpu")
    P, d = swar.kmajor_repack(w)
    assert P.dtype == torch.int32 and tuple(P.shape) == (k // 8, n)
    assert tuple(d.shape) == (k // 32, n)
    back = swar.kmajor_unpack(P, d)
    assert torch.equal(back["qs"], w["qs"]) and torch.equal(back["d"], w["d"])
    # word (r, c) holds nibbles k = 8r..8r+7 of row c, in element order
    q = int_values(w)
    words = P.to(torch.int64) & 0xFFFFFFFF
    for t in range(8):
        assert torch.equal((words >> (4 * t)) & 0xF,
                           q[:, t::8].T.to(torch.int64))


def test_kmajor_plain_matches_jax_swar_mm(probe_swar):
    rng = np.random.default_rng(0)  # check_correct's inputs
    n, k, b = 512, 1024, 8
    V = rng.integers(0, 16, (k, n)).astype(np.int64)
    D = (rng.random((k // 32, n)).astype(np.float32) + 0.5) * 0.01
    x = rng.standard_normal((b, k)).astype(np.float32)
    D = D.astype(np.float16).astype(np.float32)  # the port's f16 scales
    order = probe_swar.probe_bitcast_order()
    plo, phi = probe_swar.perms(k, order)
    yj = np.asarray(probe_swar.swar_mm(
        jnp.asarray(x[:, plo]), jnp.asarray(x[:, phi]),
        jnp.asarray(probe_swar.pack_plane(V)), jnp.asarray(D), n, k, 256))
    w = _q4_0(V, D)
    P, d = swar.kmajor_repack(w)
    yp = swar.kmajor_matmul(torch.from_numpy(x), P, d).numpy()
    wf = (V - 8).astype(np.float32) * np.repeat(D, 32, axis=0)
    sums = np.abs(x) @ np.abs(wf)
    assert np.all(np.abs(yp - yj) <= 1e-5 * sums)
    assert np.all(np.abs(yp - x @ wf) <= 1e-5 * sums)


def test_byte_order_plain_matches_jax(probe_swar):
    order = probe_swar.probe_bitcast_order()  # its 8 words, bytes 4r + b
    src = torch.arange(32, dtype=torch.int32).to(torch.uint8)
    m, v = swar.byte_order(src)
    assert swar.byte_order_label(m) == order == "4r+b"
    assert torch.equal(m, torch.arange(32, dtype=torch.int32))
    assert torch.equal(v, m.to(torch.float32))


def test_f16_decode_plain_matches_jax_decode_kernel():
    from jax.experimental import pallas as pl

    from ggmlsharp_tpu.kernels.matmul_q import _decode_f16x2_arr

    pats = np.arange(65536, dtype=np.uint32).reshape(2, 128, 256)
    plane = pats[0] | (pats[1] << 16)

    def decode_kernel(p_ref, o_ref):
        o_ref[:] = _decode_f16x2_arr(p_ref[:])

    got = np.asarray(jax.jit(lambda p: pl.pallas_call(
        decode_kernel,
        out_shape=jax.ShapeDtypeStruct((256, 256), jnp.float32),
        interpret=True)(p))(plane))
    port = scale_decode.f16_decode(scale_decode.all_f16())
    bad, finite = scale_decode.decode_mismatches(
        torch.from_numpy(got.reshape(-1).copy()), port)
    assert finite == 63488 and bad == 0


@pytest.mark.parametrize("fmt", sorted(scale_decode.MAP_BLOCK, key=int),
                         ids=lambda g: g.name)
def test_block_map_plain_is_a_block_repeat(fmt):
    bs = scale_decode.MAP_BLOCK[fmt]
    k = scale_decode.MAP_K
    d = torch.arange(1, k // bs + 1, dtype=torch.float32)
    got = scale_decode.block_map(fmt, d, k)
    assert torch.equal(got, torch.from_numpy(np.repeat(d.numpy(), bs)))


def test_bad_entry_map_plain_has_none():
    row = scale_decode.bad_entry_map(torch.device("cpu"))
    assert row["bad_entries"] == 0 and row["entries"] == 2048


def test_q4_0_plain_matches_dq_variants_arithmetic():
    rng = np.random.default_rng(3)
    n, k, b = 256, 4096, 2
    V = rng.integers(0, 16, (k, n)).astype(np.int64)
    D = (rng.random((k // 32, n)) * 0.01).astype(np.float16).astype(np.float32)
    x = rng.standard_normal((b, k)).astype(np.float32)
    want = x @ ((V - 8).astype(np.float32) * np.repeat(D, 32, axis=0))
    got = mul_mat_q(_q4_0(V, D), torch.from_numpy(x),
                    quantize_acts=False).numpy()
    sums = np.abs(x) @ np.abs((V - 8) * np.repeat(D, 32, axis=0))
    assert np.all(np.abs(got - want) <= 1e-5 * sums)


def _half2_emulated(x, w):
    """matmul_q4_0.cu's half2 build, every f16 rounding where the kernel
    rounds (x to f16; a lane-half's 4 products by hmul then hfma, each one
    rounding: the product of two f16 values is exact in f32), the f32 part
    in plain order."""
    n, k = w.shape
    q = (int_values(w) - 8).to(torch.float16).reshape(n, k // 32, 32)
    dw = w["d"].to(torch.float32)
    xh = x.to(torch.float16).reshape(x.shape[0], k // 32, 32)
    out = torch.zeros((x.shape[0], n))
    for j in (0, 4, 8, 12):
        for lo in (0, 1):  # the two halves of a __half2
            idx = [j + lo, j + 2 + lo, j + 16 + lo, j + 18 + lo]
            h = (xh[:, None, :, idx[0]].float()
                 * q[None, :, :, idx[0]].float()).half()
            for e in idx[1:]:
                h = (xh[:, None, :, e].float() * q[None, :, :, e].float()
                     + h.float()).half()
            out += (h.float() * dw[None]).sum(-1)
    return out


def test_half2_bar_holds_for_the_emulated_half2_build():
    from ggmlsharp_tpu_torch.models.llama import random_q4_0

    gen = torch.Generator().manual_seed(0)
    w = random_q4_0(64, 4096, gen, "cpu")
    x = torch.randn((2, 4096), generator=gen)
    want = mul_mat_q(w, x, quantize_acts=False)
    err = (_half2_emulated(x, w) - want).abs()
    bar = dq_variants.half2_bar(dq_variants.abs_sums(x, w))
    assert float(err.max()) > 0 and bool((err <= bar).all())
    # the bar is not loose by orders of magnitude
    assert float((err / bar).max()) > 1e-3


def test_probes_refuse_the_cpu_unless_asked():
    from ggmlsharp_tpu_torch.kernels import autotune

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for main in (dq_variants.main, swar.main, scale_decode.main,
                 q8_acts.main, autotune.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
    assert autotune.main(["--device", "cpu"]) == 0
    assert scale_decode.main(["--device", "cpu"]) == 0
    assert q8_acts.main(["--device", "cpu"]) == 0


def test_q8_0_plain_matches_q8_acts_block_arithmetic():
    # the plain version within 1e-5 of sum |x||w| (the two builds' bar) of
    # the integer sums both builds take, folded by d_w * d_x a block
    assert q8_acts.plain_check(torch.device("cpu")) <= 1.0


def test_q8_acts_variants_are_separate_builds():
    from ggmlsharp_tpu_torch.kernels import _build

    assert q8_acts.variant_defines("i8") == ()
    assert q8_acts.variant_defines("bf16") == ("Q8_ACTS=1",)
    paths = set()
    for v in q8_acts.VARIANTS:
        with q8_acts.variant(v):
            assert _build._DEFINES[q8_acts.ENTRY] == q8_acts.variant_defines(v)
            paths.add(_build.library_path(q8_acts.ENTRY))
    assert len(paths) == 2
    assert _build._DEFINES.get(q8_acts.ENTRY, ()) == ()
