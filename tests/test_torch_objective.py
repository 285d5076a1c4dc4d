"""Parity of the port's objective module (repro_torch.core.objective) with
the JAX reference (repro.core.objective) on the same numpy inputs,
extreme margins included. Tolerance: rtol 1e-5 (float32 rounding of two
implementations of the same formula)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the packages re-export a function named ``objective``: take the modules
jobj = importlib.import_module("repro.core.objective")
tobj = importlib.import_module("repro_torch.core.objective")

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6

# margins spanning the clamp and overflow regions (|m| >= 88 overflows a
# naive exp in float32)
EXTREME = np.array([0.0, 1e-3, -1e-3, 5.0, -5.0, 11.5, -11.5, 20.0, -20.0,
                    40.0, -40.0, 88.0, -88.0, 100.0, -100.0], np.float32)


def _inputs(seed, n=512, p=24, scale=4.0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p), dtype=np.float32)
    beta = (rng.standard_normal(p, dtype=np.float32)
            * (rng.random(p) < 0.5)).astype(np.float32)
    m = np.concatenate([scale * rng.standard_normal(n - EXTREME.size, dtype=np.float32),
                        EXTREME])
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    return X, beta, m, y


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["margins", "neg_log_likelihood", "l1_norm",
                                  "objective", "grad_nll_from_margins",
                                  "lambda_max"])
def test_objective_functions_match_reference(name, seed):
    X, beta, m, y = _inputs(seed)
    lam = 0.7
    args = {
        "margins": lambda mod, a: mod.margins(a(X), a(beta)),
        "neg_log_likelihood": lambda mod, a: mod.neg_log_likelihood(a(m), a(y)),
        "l1_norm": lambda mod, a: mod.l1_norm(a(beta)),
        "objective": lambda mod, a: mod.objective(a(m), a(y), a(beta), lam),
        "grad_nll_from_margins": lambda mod, a: mod.grad_nll_from_margins(a(m), a(y), a(X)),
        "lambda_max": lambda mod, a: mod.lambda_max(a(X), a(y)),
    }[name]
    ref = args(jobj, jnp.asarray)
    got = args(tobj, _t)
    rtol = 1e-4 if name in ("margins", "grad_nll_from_margins") else RTOL
    # matmul sums in another order: 1e-4 relative, 1e-5 absolute near zero
    _close(got, ref, rtol=rtol, atol=1e-5 if rtol > RTOL else ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_working_stats_match_reference(seed):
    _, _, m, y = _inputs(seed, n=4096)
    w_ref, z_ref = jobj.working_stats(jnp.asarray(m), jnp.asarray(y))
    w, z = tobj.working_stats(_t(m), _t(y))
    _close(w, w_ref)
    p = 1.0 / (1.0 + np.exp(-m.astype(np.float64)))
    # z = ((y+1)/2 - p) / (p(1-p)) cancels in 1 - p as p -> 1: one float32
    # ulp of p (6e-8) moves z by 6e-8 / (1 - p) relative
    rtol = np.maximum(RTOL, 4 * 6e-8 / np.clip(1.0 - p, 1e-5, 1.0))
    err = np.abs(z.numpy().astype(np.float64) - np.asarray(z_ref, np.float64))
    assert np.all(err <= ATOL + rtol * np.abs(np.asarray(z_ref, np.float64))), err.max()


def test_nll_is_finite_at_extreme_margins():
    m = _t(EXTREME)
    for y in (1.0, -1.0):
        yy = torch.full_like(m, y)
        nll = tobj.neg_log_likelihood(m, yy)
        ref = jobj.neg_log_likelihood(jnp.asarray(EXTREME), jnp.full(EXTREME.shape, y))
        assert torch.isfinite(nll)
        _close(nll, ref)


@pytest.mark.parametrize("a", [0.0, 0.5, 3.0])
def test_soft_threshold_matches_reference(a):
    x = np.linspace(-5, 5, 101).astype(np.float32)
    _close(tobj.soft_threshold(_t(x), a), jobj.soft_threshold(jnp.asarray(x), a), atol=0)
