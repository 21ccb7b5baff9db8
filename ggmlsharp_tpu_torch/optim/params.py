"""Optimizer parameter and result types (port of
ggmlsharp_tpu/optim/params.py: ggml_opt_params, with the defaults of
ggml_opt_default_params)."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field


class OptType(enum.Enum):
    ADAM = 0
    LBFGS = 1


class LineSearch(enum.IntEnum):
    ARMIJO = 0
    WOLFE = 1
    STRONG_WOLFE = 2

    DEFAULT = 1


class OptResult(enum.Enum):
    OK = 0
    DID_NOT_CONVERGE = 1
    NO_CONTEXT = 2
    INVALID_WOLFE = 3
    FAIL = 4
    LBFGS_MAX_LINESEARCH = 5  # GGML_LINESEARCH_MAXIMUM_ITERATIONS


@dataclass
class AdamParams:
    n_iter: int = 10000
    alpha: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    eps_f: float = 1e-5  # relative Δf convergence
    eps_g: float = 1e-3
    # later-ggml extensions (absent from the reference's May-2023 snapshot)
    weight_decay: float = 0.0  # AdamW decoupled decay
    gclip: float = 0.0  # global-norm gradient clip (0 = off)


@dataclass
class LBFGSParams:
    m: int = 6
    n_iter: int = 100
    max_linesearch: int = 20
    eps: float = 1e-5  # ‖g‖/max(1,‖x‖) convergence
    ftol: float = 1e-4  # Armijo sufficient-decrease
    wolfe: float = 0.9  # curvature condition
    min_step: float = 1e-20
    max_step: float = 1e20
    linesearch: LineSearch = LineSearch.DEFAULT


@dataclass
class OptParams:
    type: OptType = OptType.ADAM
    past: int = 0  # Δf window (0 = disabled)
    delta: float = 1e-5
    max_no_improvement: int = 100
    adam: AdamParams = field(default_factory=AdamParams)
    lbfgs: LBFGSParams = field(default_factory=LBFGSParams)


def opt_default_params(type_: OptType = OptType.ADAM) -> OptParams:
    p = OptParams(type=type_)
    if type_ == OptType.LBFGS:
        p.max_no_improvement = 0
    return p
