"""The port's dense solve (LogisticL1.fit, device="cpu") against the JAX
reference on the same numpy problem (2560 x 128 before the 20% test split,
the ``small_glm`` shape; M=4 blocks of one 32-wide tile), in both cycle
modes, at the reference's fit-vs-fit tolerances (relative objective gap
< 1e-4, betas within rtol 1e-2 / atol 1e-3, ``tests/test_distributed.py``).
Also: the line search and one outer iteration against their references,
option validation, the status lattice on poisoned data, carrying a JAX
solution over (``from_reference``), and the engine's host-read contract.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import DenseDesign as JDenseDesign
from repro.api import LogisticL1 as JLogisticL1
from repro.core.dglmnet import DGLMNETOptions as JOptions
from repro.core.dglmnet import dglmnet_iteration
from repro.core.linesearch import line_search as j_line_search
from repro_torch.api import DenseDesign, LogisticL1, from_reference
from repro_torch.configs.base import GLMConfig
from repro_torch.core import engine
from repro_torch.core.dglmnet import DGLMNETOptions, _iteration
from repro_torch.core.linesearch import line_search
from repro_torch.core.objective import lambda_max
from repro_torch.core.subproblem import layout_blocks
from repro_torch.data.synthetic import make_glm_dataset

torch.set_num_threads(2)
OPTS = dict(num_blocks=4, tile=32)


@pytest.fixture(scope="module")
def problem():
    ds = make_glm_dataset(GLMConfig(name="test", num_examples=2560, num_features=128),
                          np.random.default_rng(0), device="cpu")
    X, y = ds.X_train.numpy(), ds.y_train.numpy()
    lam = float(lambda_max(ds.X_train, ds.y_train)) / 16
    return X, y, lam, ds.X_test.numpy()


@pytest.fixture(scope="module")
def jax_fits(problem):
    X, y, lam, _ = problem
    out = {}
    for mode in ("sequential", "blocked"):
        est = JLogisticL1(opts=JOptions(cycle_mode=mode, block=8, **OPTS))
        out[mode] = (est, est.fit(JDenseDesign(jnp.asarray(X)), jnp.asarray(y), lam))
    return out


@pytest.mark.parametrize("mode", ["sequential", "blocked"])
def test_fit_matches_reference(problem, jax_fits, mode):
    X, y, lam, _ = problem
    ref = jax_fits[mode][1]
    engine.host_syncs = 0
    res = LogisticL1(DGLMNETOptions(cycle_mode=mode, block=8, **OPTS),
                     device="cpu").fit(DenseDesign(torch.from_numpy(X)), y, lam)
    assert res.ok and ref.ok
    assert abs(res.f - ref.f) / abs(ref.f) < 1e-4, (res.f, ref.f)
    np.testing.assert_allclose(res.beta.numpy(), np.asarray(ref.beta), rtol=1e-2, atol=1e-3)
    h = res.objective_history
    assert len(h) == res.n_iters + 1 and len(res.alpha_history) == res.n_iters
    assert all(h[i + 1] <= h[i] + 1e-4 * abs(h[i]) for i in range(len(h) - 1)), h
    # the engine's contract: one host read per outer iteration + one fetch
    assert engine.host_syncs == res.n_iters + 1


def test_one_outer_iteration_matches_reference(problem):
    X, y, lam, _ = problem
    rng = np.random.default_rng(1)
    beta = (0.05 * rng.standard_normal(X.shape[1]) * (rng.random(X.shape[1]) < 0.3)
            ).astype(np.float32)
    m = X @ beta
    for mode in ("sequential", "blocked"):
        opts = DGLMNETOptions(cycle_mode=mode, block=8, **OPTS)
        Xt = layout_blocks(torch.from_numpy(X), opts.num_blocks, opts.tile)
        dbeta, dm, gd = _iteration(Xt, torch.from_numpy(y), torch.from_numpy(beta),
                                   torch.from_numpy(m), lam, opts)
        dbeta0, dm0, gd0 = dglmnet_iteration(
            jnp.asarray(X), jnp.asarray(y), jnp.asarray(beta), jnp.asarray(m), lam,
            JOptions(cycle_mode=mode, block=8, **OPTS))
        np.testing.assert_allclose(dbeta.numpy(), np.asarray(dbeta0), rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(dm.numpy(), np.asarray(dm0), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(float(gd), float(gd0), rtol=1e-3)


def test_single_step_and_design_match_reference(problem):
    """engine.make_step (one outer iteration, applied) and the dense
    design's questions (margins, correlation, Gram tile) vs the reference."""
    from repro.core.engine import make_step as j_make_step
    from repro.core.dglmnet import _iteration as j_iteration
    from repro_torch.core.engine import make_step

    X, y, lam, _ = problem
    beta = np.zeros(X.shape[1], np.float32)
    opts = DGLMNETOptions(**OPTS)
    jopts = JOptions(**OPTS)
    step = make_step(lambda Xt, y_, b, m, lam_, w, z: _iteration(Xt, y_, b, m, lam_, opts, w, z))
    Xt = layout_blocks(torch.from_numpy(X), opts.num_blocks, opts.tile)
    got = step(Xt, torch.from_numpy(y), torch.from_numpy(beta), torch.zeros(X.shape[0]), lam)
    jstep = j_make_step(lambda X_, y_, b, m, lam_, w, z: j_iteration(X_, y_, b, m, lam_, jopts, w, z))
    ref = jstep(jnp.asarray(X), jnp.asarray(y), jnp.asarray(beta), jnp.zeros(X.shape[0]), lam)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-4)

    rng = np.random.default_rng(4)
    w = (0.05 + 0.2 * rng.random(X.shape[0])).astype(np.float32)
    r = rng.standard_normal(X.shape[0]).astype(np.float32)
    d, jd = DenseDesign(torch.from_numpy(X)), JDenseDesign(jnp.asarray(X))
    b = rng.standard_normal(X.shape[1]).astype(np.float32)
    pairs = [(d.margins(torch.from_numpy(b)), jd.margins(jnp.asarray(b))),
             (d.correlation(torch.from_numpy(r)), jd.correlation(jnp.asarray(r))),
             *zip(d.gram_tile(torch.from_numpy(w), torch.from_numpy(r), 32, 32),
                  jd.gram_tile(jnp.asarray(w), jnp.asarray(r), 32, 32))]
    assert d.shape == jd.shape and d.layout == jd.layout == "dense"
    for a, b in pairs:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("scale", [1e-3, 1e-2])
def test_line_search_matches_reference(problem, scale):
    """Both branches on a steepest-descent direction: a short step that
    passes Armijo at alpha = 1, and a long one that overshoots, so the
    golden section and the backtracking decide."""
    X, y, lam, _ = problem
    beta = np.zeros(X.shape[1], np.float32)
    grad = X.T @ (0.5 - (y + 1) * 0.5)
    dbeta = (-scale * grad).astype(np.float32)
    m, dm = X @ beta, X @ dbeta
    p = 1.0 / (1.0 + np.exp(-m))
    gd = float(np.dot(p - (y + 1) * 0.5, dm))
    res = line_search(*(torch.from_numpy(a) for a in (m, dm, y, beta, dbeta)), lam, gd)
    ref = j_line_search(*(jnp.asarray(a) for a in (m, dm, y, beta, dbeta)), lam, gd)
    assert bool(res.took_unit_step) == bool(ref.took_unit_step)
    assert int(res.backtracks) == int(ref.backtracks)
    # near the golden-section minimum f is flat to float32 rounding, so the
    # two implementations may stop 1e-4 apart in alpha at the same f
    np.testing.assert_allclose(float(res.alpha), float(ref.alpha), rtol=1e-3)
    np.testing.assert_allclose(float(res.f_new), float(ref.f_new), rtol=1e-5)


@pytest.mark.parametrize("bad", [
    dict(cycle_mode="fast"), dict(method="newton"), dict(block=3), dict(block=0),
    dict(tile=0), dict(num_blocks=0), dict(n_cycles=0), dict(max_iters=0),
    dict(device_budget_bytes=0),
])
def test_options_validation_matches_reference(bad):
    with pytest.raises(ValueError) as ref:
        JOptions(**bad)
    with pytest.raises(ValueError) as got:
        DGLMNETOptions(**bad)
    assert str(got.value) == str(ref.value)


def test_blocked_cycle_shape_rejected_at_fit(problem):
    X, y, lam, _ = problem
    with pytest.raises(ValueError, match="to divide tile"):
        LogisticL1(DGLMNETOptions(tile=24, block=16, cycle_mode="blocked"),
                   device="cpu").fit(X, y, lam)


def test_poisoned_data_trips_the_same_status(problem):
    X, y, lam, _ = problem
    Xp = X.copy()
    Xp[5, 3] = np.nan
    ref = JLogisticL1(opts=JOptions(**OPTS)).fit(JDenseDesign(jnp.asarray(Xp)),
                                                 jnp.asarray(y), lam)
    res = LogisticL1(DGLMNETOptions(**OPTS), device="cpu").fit(Xp, y, lam)
    assert res.status == ref.status != engine.STATUS_OK
    assert res.status_name == ref.status_name
    assert res.n_iters == ref.n_iters
    assert torch.isfinite(res.beta).all()


def test_from_reference_scores_like_the_reference(problem, jax_fits):
    X, y, lam, X_test = problem
    jest, jres = jax_fits["sequential"]
    est = LogisticL1(DGLMNETOptions(**OPTS), device="cpu",
                     **from_reference(np.asarray(jres.beta), lam, device="cpu"))
    assert est.lam_ == lam and est.coef_.dtype == torch.float32
    d_ref = np.asarray(jest.decision_function(JDenseDesign(jnp.asarray(X_test))))
    p_ref = np.asarray(jest.predict_proba(JDenseDesign(jnp.asarray(X_test))))
    np.testing.assert_allclose(est.decision_function(X_test).numpy(), d_ref,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(est.predict_proba(DenseDesign(torch.from_numpy(X_test))).numpy(),
                               p_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(est.predict(X_test).numpy(),
                                  np.asarray(jest.predict(JDenseDesign(jnp.asarray(X_test)))))
    # warm start from the JAX solution: already optimal, so the port stops
    # within a couple of iterations at the same objective
    est.warm_start = True
    res = est.fit(X, y, lam)
    assert res.ok and res.n_iters <= 3
    assert abs(res.f - jres.f) / abs(jres.f) < 1e-4


def test_estimator_surface():
    est = LogisticL1(device="cpu")
    assert est.intercept_ == 0.0 and est.coef_ is None
    assert set(est.get_params()) == {"opts", "mesh", "device", "warm_start"}
    assert est.set_params(warm_start=True).warm_start is True
    with pytest.raises(ValueError, match="unknown parameter"):
        est.set_params(lam=0.1)
    with pytest.raises(ValueError, match="not fitted"):
        est.decision_function(np.zeros((2, 3), np.float32))
