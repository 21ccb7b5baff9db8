"""Optimizers: Adam and L-BFGS with backtracking line search (port of
ggmlsharp_tpu/optim, ggml_opt), and their torch.optim interop
(optax_compat: GgmlAdam for JAX's as_optax, opt_torch for opt_optax)."""

from .params import (
    AdamParams,
    LBFGSParams,
    LineSearch,
    OptParams,
    OptResult,
    OptType,
    opt_default_params,
)
from .adam import opt_adam
from .lbfgs import opt_lbfgs, opt_lbfgs_host, opt_lbfgs_jit
from .facade import opt, opt_fn, value_and_grad
from .optax_compat import GgmlAdam, opt_torch

__all__ = [
    "AdamParams",
    "GgmlAdam",
    "LBFGSParams",
    "LineSearch",
    "OptParams",
    "OptResult",
    "OptType",
    "opt",
    "opt_adam",
    "opt_default_params",
    "opt_fn",
    "opt_lbfgs",
    "opt_lbfgs_host",
    "opt_lbfgs_jit",
    "opt_torch",
    "value_and_grad",
]
