"""The synchronisation buffers of the persistent whole-block kernels
(``csrc/persist.cuh``; ``llama_layer.cu`` and ``gpt2_layer.cu``).

A launch of either kernel takes an int32 buffer: the grid barrier's word
(its top bit flips at each barrier; ``llama_layer.cu``), the launch
generation (``gpt2_layer.cu``: one more a launch), then one counter a head.
Every launch leaves it as it found it (the barrier word's low 31 bits and
the counters 0), so one buffer serves
every launch on a stream, of both kernels (launches on one stream run one at
a time), and a CUDA graph that captured its address stays valid: the buffer
is made once for each (device, stream) and never reallocated.
"""
from __future__ import annotations

import torch

MAX_HEADS = 1024  # the heads a buffer counts for
_SYNC: dict = {}  # (device, stream) -> int32 [2 + MAX_HEADS]


_XCH: dict = {}  # (device, stream, words) -> int64 [words]


def exchange_buffer(device, stream: int, words: int) -> torch.Tensor:
    """The GPT-2 block kernel's exchanged vectors for launches on ``stream``
    of ``device``: ``words`` 64-bit words, each a value and the generation
    of the launch that wrote it; zeroed once (no launch's generation is 0),
    never reallocated, one a size."""
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
