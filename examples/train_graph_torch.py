"""ggml-style graph training with the PyTorch/CUDA port (counterpart of
examples/train_graph.py): the reference's Test2 workflow, verbatim through
the compat layer, and the functional optimizer API.

    python examples/train_graph_torch.py [--device cuda]

Runs on the card unless --device cpu.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def line_fit(dev):
    """Test2 case 1 through the ggml API: Adam fits y = t0 + t1 x by least
    squares (expect 5, 10). Returns (t0, t1)."""
    import torch

    from ggmlsharp_tpu_torch.compat import (
        GGML_OPT_ADAM, ggml_add, ggml_div, ggml_get_f32_1d, ggml_init,
        ggml_mul, ggml_new_f32, ggml_new_tensor_1d, ggml_opt,
        ggml_opt_default_params, ggml_repeat, ggml_set_param, ggml_sqr,
        ggml_sub, ggml_sum, set_data)
    from ggmlsharp_tpu_torch.dtypes import GType

    ctx = ggml_init(device=dev)
    xi = [1.0, 2, 3, 4, 5, 6, 7, 8, 9, 10]
    yi = [15.0, 25, 35, 45, 55, 65, 75, 85, 95, 105]
    n = len(xi)
    x = set_data(ggml_new_tensor_1d(ctx, GType.F32, n), torch.tensor(xi))
    y = set_data(ggml_new_tensor_1d(ctx, GType.F32, n), torch.tensor(yi))
    t0 = ggml_new_f32(ctx, 0.0)
    t1 = ggml_new_f32(ctx, 0.0)
    ggml_set_param(ctx, t0)
    ggml_set_param(ctx, t1)
    pred = ggml_add(ctx, ggml_mul(ctx, x, ggml_repeat(ctx, t1, x)),
                    ggml_repeat(ctx, t0, x))
    f = ggml_div(ctx, ggml_sum(ctx, ggml_sqr(ctx, ggml_sub(ctx, pred, y))),
                 ggml_new_f32(ctx, 2.0 * n))
    params = ggml_opt_default_params(GGML_OPT_ADAM)
    params.adam.alpha = 0.01
    ggml_opt(ctx, params, f)
    return ggml_get_f32_1d(t0, 0), ggml_get_f32_1d(t1, 0)


def rosenbrock(dev):
    """L-BFGS on Rosenbrock from (-1.2, 1) through opt_fn. Returns ((a, b),
    f, OptResult, iterations)."""
    import torch

    from ggmlsharp_tpu_torch.optim import OptParams, OptType, opt_fn

    def rosen(p):
        a, b = p
        return (1 - a) ** 2 + 100.0 * (b - a * a) ** 2

    prm = OptParams(type=OptType.LBFGS)
    prm.lbfgs.n_iter = 200
    x0 = (torch.tensor(-1.2, device=dev), torch.tensor(1.0, device=dev))
    return opt_fn(rosen, x0, prm)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ggmlsharp_tpu_torch import resolve_device

    dev = resolve_device(args.device)
    t0, t1 = line_fit(dev)
    print(f"adam line fit: t0={t0:.4f} t1={t1:.4f}  (expect 5, 10)")
    (a, b), fx, res, iters = rosenbrock(dev)
    print(f"lbfgs rosenbrock: ({float(a):.4f}, {float(b):.4f}) "
          f"f={float(fx):.2e} in {iters} iters ({res.name})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
