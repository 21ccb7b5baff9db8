"""Kernel dispatch switches (port of ggmlsharp_tpu/kernels/config.py).

``set_kernels(None | True | False)`` is the counterpart of ``set_pallas``:

  * None (auto, the default): a wrapper launches its kernel for a CUDA
    tensor and runs its plain PyTorch version for a CPU tensor;
  * False: every wrapper runs its plain version, on the card too. It makes
    ``plain=True`` the default of ``ops.mul_mat``, attention and the fused
    routes: an explicit choice of the caller, like the JAX package's
    ``use_pallas=False``;
  * True: every wrapper launches its kernel, and a CPU tensor raises: no
    kernel runs there.

The JAX package's ``GGML_TPU_FORCE_PALLAS=1`` (its kernels in interpret mode
on any backend, for kernel tests on the CPU) has no counterpart: a CUDA
kernel has no interpreter, so the CPU tests hold each plain version against
the JAX package and ``chip_smoke.py`` holds each kernel against its plain
version on the card.

``mm_dot_mode`` / ``set_mm_dot`` take the JAX package's two values. Its
kernels that take ``mode`` read it (the dequant-matmuls and decode
attention), and so do the port's counterparts, kernel and plain version
alike:

  * "f32": today's exact function. A dequant-matmul multiplies f32
    activations exactly (three bf16 planes on the tensor cores, f32 FMAs at
    b = 1); decode attention runs in f32 throughout.
  * "bf16" (the default, as in JAX): the activation operand is rounded to
    bf16 once and the products accumulate in f32. A dequant-matmul rounds
    f32 x where its b = 1 instance loads it and into one plane in its
    multi-row instance (the weights' integer values are exact in bf16, so
    only x rounds); Q8 activations are exact in both modes. Decode
    attention over a bf16 or INT8 cache feeds the score products the
    scaled query rounded to bf16 and the value products the softmax
    weights rounded to bf16 (for INT8, the weight times the row's V
    scale), as the JAX kernel's fast mode does; so that this rounding does
    not depend on the order the cache rows are taken in, the softmax runs
    in base 2 against an integer running maximum. The fresh row stays f32.
  * The fused GELU MLP's f32 x follows the mode too; kernels with no mode
    in JAX (flash, the SwiGLU MLP, the whole-block kernels) ignore it.

The difference between the modes is bf16 rounding, within the noise bar
the tests hold (2^-8·|x·w|·sqrt(K)). Its one source is
``config.RuntimeConfig.mm_dot`` (GGML_TPU_MM_DOT); ``set_mm_dot``
overrides it, as ``RuntimeConfig.apply`` does.
"""
from __future__ import annotations

import torch

from .. import config

_override: bool | None = None
H100_SMS = 132  # streaming multiprocessors of an H100 SXM
_SMS: dict = {}  # device -> its streaming multiprocessors


def device_sms(device) -> int:
    """The streaming multiprocessors of CUDA device ``device`` (read once):
    what the split choosers (attn_decode.decode_splits,
    matmul_q.mma_splits) fill."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def kernels_enabled() -> bool:
    """The forced setting, else whether a card is there (auto: kernels for
    CUDA tensors): the counterpart of ``pallas_enabled``."""
    if _override is not None:
        return _override
    return torch.cuda.is_available()


def kernels_setting() -> bool | None:
    """The switch as set: None (auto), True or False."""
    return _override


def set_kernels(enabled: bool | None):
    """True / False to force; None to restore auto."""
    global _override
    if enabled not in (None, True, False):
        raise ValueError(f"set_kernels: {enabled!r} is not None, True or "
                         f"False")
    _override = enabled


def use_kernel(t: torch.Tensor, plain: bool = False) -> bool:
    """Whether a wrapper given tensor ``t`` launches its kernel (else it
    runs its plain version). Raises when kernels are forced on and ``t``
    lies on the CPU."""
    if plain or _override is False:
        return False
    if t.is_cuda:
        return True
    if _override:
        raise RuntimeError("kernels are forced on (set_kernels(True)) but "
                           "the tensor lies on the CPU, where no kernel runs")
    return False


_MM_DOT_MODES = ("bf16", "f32")
_mm_dot: str | None = None  # set_mm_dot's override; None: the config's


def mm_dot_mode() -> str:
    return _mm_dot if _mm_dot is not None else config.get_config().mm_dot


def round_x(mode: str) -> int:
    """1 where mm_dot ``mode`` rounds the activation operand to bf16 (the
    C entries' ``rx``), else 0; raises on an unknown mode."""
    if mode not in _MM_DOT_MODES:
        raise ValueError(f"mm_dot mode {mode!r} is not one of "
                         f"{_MM_DOT_MODES}")
    return int(mode == "bf16")


def set_mm_dot(mode: str):
    global _mm_dot
    if mode not in _MM_DOT_MODES:
        raise ValueError(f"set_mm_dot: {mode!r} is not one of "
                         f"{_MM_DOT_MODES}")
    _mm_dot = mode
