"""Optimizers: Adam and L-BFGS with backtracking line search (port of
ggmlsharp_tpu/optim, ggml_opt)."""

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
from .lbfgs import opt_lbfgs
from .facade import opt, opt_fn, value_and_grad

__all__ = [
    "AdamParams",
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
    "value_and_grad",
]
