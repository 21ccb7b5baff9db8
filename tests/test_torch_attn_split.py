"""The split-K decode attention of the port's kernel 3, and the flash
wrapper's argument checks, on the CPU.

``_decode_ref_split`` is the kernel's algorithm in plain PyTorch (a partial
softmax state a split of the cache rows, then the merge); it is held
against the dense ``_decode_ref`` and against the JAX package's
``flash_decode_flat`` (its Pallas kernel in interpret mode, exact f32
mode), for 1, 2 and 7 splits and for more splits than live rows, with
npast 0 and npast at or past the prefix view. Tolerance: both sides are
f32 and differ in summation order and the online vs dense softmax: 2e-5,
as tests/test_torch_attn_decode.py.

``decode_splits`` is the host's choice of splits: never 0, never more
than the rows, at least two blocks an SM where the rows allow, at least
64 rows a split.
"""
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.kernels import config as jkcfg
from ggmlsharp_tpu_torch.kernels import attn_decode as ad
from ggmlsharp_tpu_torch.kernels import flash
from test_torch_attn_decode import _inputs, _jax

B, HQ, HKV, D, T = 3, 8, 2, 64, 48
NPASTS = {"npast0": [0, 0, 0], "past_view": [T, T + 9, 200],
          "mixed": [0, 17, T + 1]}


def _torch(inp, cache):
    q, kn, vn, kc, vc, ks, vs, npast = inp
    conv = (lambda x: torch.from_numpy(x).to(torch.bfloat16)) \
        if cache == "bf16" else torch.from_numpy
    scales = {} if ks is None else {"k_scale": torch.from_numpy(ks),
                                    "v_scale": torch.from_numpy(vs)}
    return (torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
            conv(kc), conv(vc), torch.from_numpy(npast)), scales


@pytest.mark.parametrize("splits", [1, 2, 7, T])
@pytest.mark.parametrize("npast", sorted(NPASTS))
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_split_ref_matches_dense_and_jax(splits, npast, cache):
    """splits = T: more splits than live rows (npast0, mixed) leaves most
    splits empty; they must add nothing."""
    inp = _inputs(B, HQ, HKV, D, T, NPASTS[npast], cache)
    args, scales = _torch(inp, cache)
    got = ad._decode_ref_split(*args, HKV, D, **scales, splits=splits)
    dense = ad._decode_ref(*args, HKV, D, **scales)
    prev = jkcfg.mm_dot_mode()
    jkcfg.set_mm_dot("f32")
    try:
        want = _jax(inp, HKV, D, cache)
    finally:
        jkcfg.set_mm_dot(prev)
    assert got.shape == (B, HQ, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_split_ref_npast0_is_the_fresh_row():
    """npast = 0 in every slot: every split but 0 is empty, and the answer
    is the fresh V row itself, whatever the cache holds."""
    inp = _inputs(B, HQ, HKV, D, T, [0, 0, 0], "int8")
    (q, kn, vn, kc, vc, npast), scales = _torch(inp, "int8")
    got = ad._decode_ref_split(q, kn, vn, kc, vc, npast, HKV, D, **scales,
                               splits=5)
    want = vn.reshape(B, HKV, 1, D).expand(B, HKV, HQ // HKV, D)
    torch.testing.assert_close(got, want.reshape(B, HQ, D), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("splits", [0, T + 1])
def test_split_ref_refuses_bad_splits(splits):
    inp = _inputs(B, HQ, HKV, D, T, [5, 5, 5], "bf16")
    args, scales = _torch(inp, "bf16")
    with pytest.raises(ValueError, match="splits"):
        ad._decode_ref_split(*args, HKV, D, splits=splits)


@pytest.mark.parametrize("splits", [None, 3])
def test_attn_lane_map_plain_takes_splits(splits):
    """_decode_ref_attn with splits is _decode_ref_split in the "attn" map,
    and agrees with the dense version."""
    Hq, Hkv, Dh, Tn = 8, 4, 64, 40
    rng = np.random.default_rng(5)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    q, kn, vn = f(2, Hq * Dh), f(2, Hkv * Dh), f(2, Hkv * Dh)
    kc, vc = (f(2, Tn, Hkv * Dh).to(torch.bfloat16) for _ in range(2))
    npast = torch.tensor([13, Tn + 2])
    args = (q, kn, vn, kc, vc, npast, Hq, Hkv, Dh)
    got = ad._decode_ref_attn(*args, splits=splits)
    want = ad._decode_ref_attn(*args)
    assert got.shape == (2, Hq * Dh)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


GRID = [(bh, rows) for bh in (1, 2, 8, 32, 64, 96, 132, 256, 264, 1000)
        for rows in (1, 16, 63, 64, 65, 300, 2048, 4100, 100000)]


@pytest.mark.parametrize("bh,rows", GRID)
def test_decode_splits_bounds(bh, rows):
    sms = ad.H100_SMS
    z = ad.decode_splits(bh, rows)
    assert 1 <= z <= min(rows, ad.MAX_SPLITS)
    if z > 1:
        assert -(-rows // z) >= 64 and rows // z >= 64  # 64 rows a split
        assert bh * z <= 4 * sms  # one wave of four blocks an SM
    if bh < 2 * sms and rows // 64 >= -(-2 * sms // bh):
        assert bh * z >= 2 * sms  # two blocks an SM where the rows allow


def test_decode_splits_takes_the_device_sms_and_refuses_nonsense():
    assert ad.decode_splits(32, 2048, sms=66) == 8
    assert ad.decode_splits(32, 2048, sms=132) == 16
    for args in ((0, 10), (4, 0), (4, 10, 0)):
        with pytest.raises(ValueError, match="decode_splits"):
            ad.decode_splits(*args)


# --- the flash wrapper's argument checks (run before any launch) ----------

def _kv(B_=2, H=2, Ta=24, Dh=32, dtype=torch.bfloat16):
    return torch.zeros((B_, H, Ta, Dh), dtype=dtype)


def test_flash_check_kv_takes_a_prefix_view():
    k = _kv()
    view = k[:, :, :10]
    assert flash._check_kv(view, view, torch.zeros(2)) == 24 * 32
    assert flash._check_kv(k, k.clone(), torch.zeros(2)) == 24 * 32


@pytest.mark.parametrize("bad", ["shape", "dtype", "layout", "int_dtype",
                                 "strided_rows", "head_major_batch"])
def test_flash_check_kv_refuses(bad):
    k = _kv()
    v = k.clone()
    err = ValueError
    if bad == "shape":
        v = _kv(Ta=23)
    elif bad == "dtype":
        v = k.float()
    elif bad == "layout":
        v = k.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "int_dtype":
        k = v = _kv(dtype=torch.int8)
        err = TypeError
    elif bad == "strided_rows":
        k = v = _kv(Dh=64)[..., ::2]
    elif bad == "head_major_batch":
        k = v = torch.zeros((2, 2, 24, 32), dtype=torch.bfloat16)\
            .transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(err):
        flash._check_kv(k, v, torch.zeros(2))
