"""Shared serving helpers (port of ggmlsharp_tpu/serving/common.py;
torch-free)."""
from __future__ import annotations


def _bucket(n: int, buckets=(16, 32, 64, 128, 256, 512, 1024, 2048)) -> int:
    """Admission prefill length bucket: the smallest of ``buckets`` >= n."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]
