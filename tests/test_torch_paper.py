"""The paper's comparison slice of the port on the CPU: the public
``dglmnet_iteration`` and the host-driven ``fit_python_loop`` against the
JAX package's and against the port's engine, the batched Jacobi solve of
the ablation against the reference's, each ``repro_torch.paper`` driver
at ``--scale tiny``, and ``repro_torch.core``'s re-exports of
``repro.core``.

Tolerances: one outer iteration as ``tests/test_torch_fit.py`` holds it
(rtol 1e-3); fits at the reference's fit-vs-fit tolerances (relative
objective gap < 1e-4, betas within rtol 1e-2 / atol 1e-3); the host loop
against the engine on one problem, the same iteration count and
objective histories within 1e-6 relative (the same float32 ops, the stop
decided in double on the host against float32 on the device).
"""
import importlib
import importlib.util

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core.dglmnet import DGLMNETOptions as JOptions
from repro.core.dglmnet import dglmnet_iteration as j_dglmnet_iteration
from repro.core.dglmnet import fit as j_fit
from repro.core.dglmnet import fit_python_loop as j_fit_python_loop
from repro_torch.api import DenseDesign, LogisticL1
from repro_torch.configs.base import GLMConfig
from repro_torch.core import engine
from repro_torch.core.dglmnet import (DGLMNETOptions, FitState, dglmnet_iteration, fit,
                                      fit_python_loop)
from repro_torch.core.objective import lambda_max
from repro_torch.data.synthetic import make_glm_dataset

torch.set_num_threads(2)
OPTS = dict(num_blocks=4, tile=32)
#: reference names of ``repro.core`` the port does not have yet (none since
#: the process mesh ported ``fit_distributed`` and ``make_dglmnet_step(_sparse)``)
NOT_YET = set()
#: the names this slice adds
SLICE = ("TGOptions", "truncated_gradient_fit", "FitState", "dglmnet_iteration",
         "fit_python_loop")


@pytest.fixture(scope="module")
def problem():
    ds = make_glm_dataset(GLMConfig(name="test", num_examples=2560, num_features=128),
                          np.random.default_rng(0), device="cpu")
    X, y = ds.X_train.numpy(), ds.y_train.numpy()
    return X, y, float(lambda_max(ds.X_train, ds.y_train)) / 16


def test_core_reexports_every_reference_name():
    for name in (n for n in dir(jcore) if not n.startswith("_")):
        if name in NOT_YET:
            assert not hasattr(tcore, name), f"{name} is ported: take it off NOT_YET"
            continue
        found = (hasattr(tcore, name)
                 or importlib.util.find_spec(f"repro_torch.core.{name}") is not None)
        assert found, f"repro.core.{name} has no counterpart in repro_torch.core"
    for name in SLICE:
        assert name in dir(tcore)
        assert getattr(importlib.import_module("repro_torch.core"), name) is not None
    from repro_torch.core import TGOptions, truncated_gradient_fit  # noqa: F401
    from repro_torch.core.truncated_gradient import TGOptions as T2

    assert TGOptions is T2 and tcore.FitState is FitState
    from repro_torch.core.distributed import fit_distributed, make_dglmnet_step_sparse

    assert tcore.fit_distributed is fit_distributed
    assert tcore.make_dglmnet_step_sparse is make_dglmnet_step_sparse
    with pytest.raises(AttributeError):
        tcore.not_a_reference_name  # noqa: B018


@pytest.mark.parametrize("overrides", [dict(), dict(cycle_mode="blocked", block=8),
                                       dict(method="jacobi")])
def test_dglmnet_iteration_matches_reference(problem, overrides):
    X, y, lam = problem
    rng = np.random.default_rng(1)
    beta = (0.05 * rng.standard_normal(X.shape[1]) * (rng.random(X.shape[1]) < 0.3)
            ).astype(np.float32)
    m = X @ beta
    dbeta, dm, gd = dglmnet_iteration(torch.from_numpy(X), torch.from_numpy(y),
                                      torch.from_numpy(beta), torch.from_numpy(m), lam,
                                      DGLMNETOptions(**OPTS, **overrides))
    dbeta0, dm0, gd0 = j_dglmnet_iteration(jnp.asarray(X), jnp.asarray(y), jnp.asarray(beta),
                                           jnp.asarray(m), lam, JOptions(**OPTS, **overrides))
    np.testing.assert_allclose(dbeta.numpy(), np.asarray(dbeta0), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(dm.numpy(), np.asarray(dm0), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(gd), float(gd0), rtol=1e-3)


def _agree(res, ref):
    assert abs(res.f - ref.f) / abs(ref.f) < 1e-4, (res.f, ref.f)
    np.testing.assert_allclose(res.beta.numpy(), np.asarray(ref.beta), rtol=1e-2, atol=1e-3)


def test_fit_python_loop_matches_reference(problem):
    X, y, lam = problem
    ref = j_fit_python_loop(jnp.asarray(X), jnp.asarray(y), lam, opts=JOptions(**OPTS))
    res = fit_python_loop(X, y, lam, opts=DGLMNETOptions(**OPTS), device="cpu")
    _agree(res, ref)
    assert res.converged == ref.converged
    assert len(res.objective_history) == res.n_iters + 1 == len(res.alpha_history) + 1


def test_fit_python_loop_matches_the_engine(problem):
    X, y, lam = problem
    opts = DGLMNETOptions(**OPTS)
    engine.host_syncs = 0
    loop = fit_python_loop(X, y, lam, opts=opts, device="cpu")
    loop_reads = engine.host_syncs
    eng = LogisticL1(opts, device="cpu").fit(DenseDesign(torch.from_numpy(X)), y, lam)
    assert loop.n_iters == eng.n_iters
    np.testing.assert_allclose(loop.objective_history, eng.objective_history, rtol=1e-6)
    np.testing.assert_allclose(loop.alpha_history, eng.alpha_history, rtol=1e-6)
    assert loop.converged == eng.converged
    # one read of f(beta0), one per iteration, one for the snap-back
    assert loop_reads == loop.n_iters + 2


def test_jacobi_fit_matches_reference(problem):
    X, y, lam = problem
    ref = j_fit(jnp.asarray(X), jnp.asarray(y), lam,
                opts=JOptions(method="jacobi", max_iters=60, **OPTS))
    res = fit(X, y, lam, opts=DGLMNETOptions(method="jacobi", max_iters=60, **OPTS),
              device="cpu")
    assert res.ok and res.n_iters == ref.n_iters
    _agree(res, ref)


# ---------------------------------------------------------------------------
# the drivers at --scale tiny
# ---------------------------------------------------------------------------

def _lines(out, prefix):
    return [ln for ln in out.splitlines() if ln.startswith(prefix)]


def test_table2_driver(capsys):
    from repro_torch.paper import table2_datasets

    rows = table2_datasets.run("tiny", "cpu")
    out = capsys.readouterr().out
    assert len(rows) == 3 and len(_lines(out, "table2.")) == 3
    assert all(int(ln.split("nnz=")[1]) > 0 for ln in _lines(out, "table2."))


def test_table3_driver(capsys):
    from repro_torch.paper import table3_timing

    rows = table3_timing.run("tiny", "cpu")
    out = capsys.readouterr().out
    assert len(_lines(out, "table3.")) == 6
    for r in rows:
        assert r["status"] == "OK" and r["iters"] >= 1
        assert 0.0 < r["ls_share"] <= 1.0 and r["tg_pass_ms"] > 0


def test_fig1_driver(capsys):
    from repro_torch.paper import fig1_quality_sparsity as fig1

    ds_rows = fig1.run("tiny", "cpu")
    out = capsys.readouterr().out
    assert len(_lines(out, "fig1.")) == 6
    per = fig1.PATH_LEN + len(fig1.TG_LAM_DIVS) * len(fig1.TG_LRS) * fig1.TG_PASSES
    assert len(ds_rows) == 3 * per
    assert all(0.0 <= r[4] <= 1.0 for r in ds_rows)


def test_ablation_driver(capsys, monkeypatch):
    from repro_torch.paper import ablation_parallel_cd as abl

    monkeypatch.setattr(abl, "RHOS", (0.5,))     # one of the three, for time
    cells = abl.run("tiny", "cpu", warmup=False)
    out = capsys.readouterr().out
    assert len(cells) == len(abl.sweep_methods()) * len(abl.MACHINES)
    assert len(_lines(out, "ablation.rho0.5.")) == len(cells)
    assert all(np.isfinite(c["f"]) for c in cells)


def test_paper_main(capsys):
    from repro_torch.paper.__main__ import main

    assert main(["--only", "table2", "--scale", "tiny", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("name,us_per_call,derived") and len(_lines(out, "table2.")) == 3
