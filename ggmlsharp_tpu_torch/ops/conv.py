"""GGML_OP_CONV_1D_1S / CONV_1D_2S (port of ggmlsharp_tpu/ops/conv.py).

x [..., L, in_c] (one optional batch axis), w [out_c, in_c, kw] ->
[..., ceil(L / stride), out_c]: cross-correlation with half padding
(kw // 2 on the left, kw // 2 - 1 on the right for an even kw), in f32."""
from __future__ import annotations

import torch


def conv_1d(x, w, stride: int = 1):
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    kw = w.shape[-1]
    pad = kw // 2
    xs = torch.nn.functional.pad(x.to(torch.float32).transpose(1, 2),
                                 (pad, pad - (1 - kw % 2)))
    out = torch.nn.functional.conv1d(xs, w.to(torch.float32),
                                     stride=stride).transpose(1, 2)
    return out[0] if squeeze else out


def conv_1d_1s(x, w):
    return conv_1d(x, w, stride=1)


def conv_1d_2s(x, w):
    return conv_1d(x, w, stride=2)
