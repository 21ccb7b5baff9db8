"""The synchronisation buffers of the persistent kernels
(``csrc/persist.cuh``; ``llama_layer.cu``, ``gpt2_layer.cu`` and the
one-row instances of ``mlp_fused_q8.cu`` and ``mlp_fused_silu_q4.cu``).

A launch of any of them takes an int32 buffer: the grid barrier's word
(its top bit flips at each barrier), the last launch's tag (the kernels
that exchange tagged words: one more a launch), then one counter a head.
Every launch leaves it as it found it (the barrier word's low 31 bits and
the counters 0; the tag one more), so one buffer serves every launch on a
stream, of every kernel (launches on one stream run one at a time, so no
tag is used twice), and a CUDA graph that captured its address stays
valid: the buffer is made once for each (device, stream) and never
reallocated.
"""
from __future__ import annotations

import torch

MAX_HEADS = 1024  # the heads a buffer counts for
_SYNC: dict = {}  # (device, stream) -> int32 [2 + MAX_HEADS]


_XCH: dict = {}  # (device, stream, words) -> int64 [words]


def exchange_buffer(device, stream: int, words: int) -> torch.Tensor:
    """The vectors the CTAs of a launch exchange, for launches on ``stream``
    of ``device``: ``words`` 64-bit words, each a value and the tag of the
    launch that wrote it; zeroed once (no launch's tag is 0), never
    reallocated, one a size (the kernels that tag share it: their tags come
    from one sync buffer, so a word of another launch never matches)."""
    buf = _XCH.get((device, stream, words))
    if buf is None:
        buf = torch.zeros(words, dtype=torch.int64, device=device)
        _XCH[(device, stream, words)] = buf
    return buf


def sync_buffer(device, stream: int) -> torch.Tensor:
    """The barrier and arrival counters for launches on ``stream`` of
    ``device``: zeroed once, left so by every launch, never reallocated."""
    buf = _SYNC.get((device, stream))
    if buf is None:
        buf = torch.zeros(2 + MAX_HEADS, dtype=torch.int32, device=device)
        _SYNC[(device, stream)] = buf
    return buf
