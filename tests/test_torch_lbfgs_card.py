"""opt_lbfgs_jit on the card (needs a CUDA device; skips without one): the
probe is captured into a CUDA graph, and a fun_vg that cannot be captured
makes the fit raise, naming the cause, never fall back to the host loop.
Imports no JAX: the comparison is with the same function's CPU run."""
import pytest
import torch

from ggmlsharp_tpu_torch.optim import (
    OptType, lbfgs, opt_default_params, value_and_grad,
)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rosen(p):
    return (1 - p[0]) ** 2 + 100.0 * (p[1] - p[0] * p[0]) ** 2


@pytest.mark.cuda
def test_capture_failure_raises_and_never_falls_back(monkeypatch):
    dev = _card()
    host_calls = []
    monkeypatch.setattr(lbfgs, "opt_lbfgs_host",
                        lambda *a, **k: host_calls.append(a))

    def synced(v):
        f = ((v - 1.0) ** 2).sum()
        return f * 2.0 if float(f.detach()) < 0 else f

    with pytest.raises(RuntimeError, match="could not be captured"):
        lbfgs.opt_lbfgs(value_and_grad(synced), torch.zeros(8, device=dev),
                        opt_default_params(OptType.LBFGS))
    assert not host_calls


@pytest.mark.cuda
def test_captured_fit_matches_the_cpu_run():
    dev = _card()
    prm = opt_default_params(OptType.LBFGS)
    prm.lbfgs.n_iter = 200
    out = []
    for where in (dev, torch.device("cpu")):
        lbfgs.reset_counts()
        x, _, res, it = lbfgs.opt_lbfgs_jit(
            value_and_grad(_rosen), torch.tensor([-1.2, 1.0], device=where),
            prm)
        out.append((x.cpu(), res, it, dict(lbfgs.COUNTS)))
    (xc, rc, ic, cc), (xh, rh, ih, _) = out
    assert (rc, ic) == (rh, ih)
    assert cc["captures"] == 1 and cc["replays"] > 0
    torch.testing.assert_close(xc, xh, rtol=0, atol=1e-4)
