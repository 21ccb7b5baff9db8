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

``mm_dot_mode`` / ``set_mm_dot`` take the JAX package's two values, "bf16"
(its default: bf16 operands into the matrix unit, f32 accumulation) and
"f32". The port's kernels multiply f32 operands in both modes, so their
result is the JAX "f32" function; the JAX default differs from it by bf16
rounding of the operands, within the bf16 noise bar the tests hold
(2^-8·|x·w|·sqrt(K)). The mode is kept and checked, and read by nothing.
Its one source is ``config.RuntimeConfig.mm_dot`` (GGML_TPU_MM_DOT);
``set_mm_dot`` overrides it, as ``RuntimeConfig.apply`` does.
"""
from __future__ import annotations

import torch

from .. import config

_override: bool | None = None


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


def set_mm_dot(mode: str):
    global _mm_dot
    if mode not in _MM_DOT_MODES:
        raise ValueError(f"set_mm_dot: {mode!r} is not one of "
                         f"{_MM_DOT_MODES}")
    _mm_dot = mode
