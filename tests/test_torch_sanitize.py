"""The port's run-time sanitizers (``repro_torch.analysis.sanitize``), the
cases of the reference's ``tests/test_sanitizers.py`` on the port's
contract, on the CPU (where every tensor stands in for a device tensor):

* a fit is exactly k + 1 reads through the engine's counted doors (a
  slab fit k + 2), and one read fewer trips the budget;
* a screened path (dense, and a slab design on a (1, 4) mesh) runs whole
  under the sanitizer at exactly its counted reads, as the reference's
  path runs under the reference's sanitizer;
* a stray ``.item()``, ``np.asarray(t)`` or any other guarded way to the
  host raises ``HostTransferError``; the doors' budget trips with
  ``FetchBudgetExceeded``; the patches are restored after the body
  raises, and a tensor is readable again;
* a traced path reads as often as an untraced one, bit for bit;
* ``compile_sanitizer`` counts a stubbed kernel build and first library
  load, and raises over its budget; around a warm path it counts none.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.sanitize import transfer_sanitizer as j_transfer_sanitizer
from repro.api import DenseDesign as JDense
from repro.api import LogisticL1 as JLogisticL1
from repro.core.dglmnet import DGLMNETOptions as JOptions
from repro_torch.analysis.sanitize import (GUARDED_METHODS, CompileBudgetExceeded,
                                           FetchBudgetExceeded, HostTransferError,
                                           compile_sanitizer, transfer_sanitizer)
from repro_torch.api import DenseDesign, LogisticL1, ShardedDesign, SlabDesign
from repro_torch.core import engine
from repro_torch.core.dglmnet import DGLMNETOptions
from repro_torch.data import byfeature as tbf
from repro_torch.kernels import build
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.obs import observe

torch.set_num_threads(2)
OPTS = dict(num_blocks=4, tile=8, max_iters=10)
PATH_LEN = 12


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(120, 40)).astype(np.float32)
    beta = np.zeros(40)
    beta[:6] = rng.normal(size=6) * 2.0
    probs = 1.0 / (1.0 + np.exp(-(X @ beta)))
    y = np.where(rng.random(120) < probs, 1.0, -1.0).astype(np.float32)
    return torch.from_numpy(X), torch.from_numpy(y)


def _est(**kw):
    return LogisticL1(DGLMNETOptions(**dict(OPTS, **kw)), device="cpu")


def _reads(fn):
    engine.host_syncs = 0
    out = fn()
    return out, engine.host_syncs


# ---------------------------------------------------------------------------
# transfer sanitizer
# ---------------------------------------------------------------------------

def test_fit_is_k_plus_one_sanctioned_reads(problem):
    X, y = problem
    res = _est().fit(DenseDesign(X), y, lam=0.05)
    k = res.n_iters
    with transfer_sanitizer(max_fetches=k + 1) as ts:
        again = _est().fit(DenseDesign(X), y, lam=0.05)
    assert ts.fetches == k + 1 and again.n_iters == k
    assert torch.equal(again.beta, res.beta)
    with pytest.raises(FetchBudgetExceeded):
        with transfer_sanitizer(max_fetches=k):
            _est().fit(DenseDesign(X), y, lam=0.05)


def test_slab_fit_is_k_plus_two_sanctioned_reads(problem):
    # the slab-native solve on a (1, 4) mesh adds one entry read (the
    # slabs' largest row) to the fit's k + 1
    X, y = problem
    mesh = make_dev_mesh(1, 4, device="cpu")
    slab = SlabDesign.from_dense(X)            # layout preparation, on the host

    def fit():
        design = ShardedDesign(slab, mesh, tile=8)
        return LogisticL1(DGLMNETOptions(tile=8, max_iters=10), mesh=mesh,
                          device="cpu").fit(design, y, lam=0.05, densify=False)

    res = fit()
    with transfer_sanitizer(max_fetches=res.n_iters + 2) as ts:
        again = fit()
    assert ts.fetches == res.n_iters + 2 and torch.equal(again.beta, res.beta)


def test_screened_path_is_fully_audited(problem):
    X, y = problem
    path, reads = _reads(lambda: _est().path(DenseDesign(X), y, path_len=PATH_LEN))
    with transfer_sanitizer(max_fetches=reads) as ts:
        again = _est().path(DenseDesign(X), y, path_len=PATH_LEN)
    assert len(again) == PATH_LEN and ts.fetches == reads
    assert torch.equal(again.betas, path.betas)
    # the reference's path runs under the reference's sanitizer alike
    jest = JLogisticL1(opts=JOptions(**OPTS))
    with j_transfer_sanitizer(max_fetches=400) as jts:
        jpath = jest.path(JDense(jnp.asarray(X.numpy())), jnp.asarray(y.numpy()),
                          path_len=PATH_LEN)
    assert len(jpath) == PATH_LEN and PATH_LEN <= jts.fetches <= 400


def test_mesh_slab_path_is_fully_audited(problem):
    X, y = problem
    mesh = make_dev_mesh(1, 4, device="cpu")
    slab = SlabDesign.from_dense(X)

    def run():
        design = ShardedDesign(slab, mesh, tile=8)
        return LogisticL1(DGLMNETOptions(tile=8, max_iters=10), mesh=mesh,
                          device="cpu").path(design, y, path_len=4)

    path, reads = _reads(run)
    with transfer_sanitizer(max_fetches=reads) as ts:
        again = run()
    assert ts.fetches == reads and torch.equal(again.betas, path.betas)


@pytest.mark.parametrize("way", ["item", "float", "int", "bool", "index", "tolist",
                                 "numpy", "cpu", "np.asarray"])
def test_unsanctioned_read_trips(way):
    x = torch.ones(4)
    read = {"item": lambda: x.sum().item(), "float": lambda: float(x.sum()),
            "int": lambda: int(x[0]), "bool": lambda: bool(x[0]),
            "index": lambda: [0, 1][x.long()[0]], "tolist": lambda: x.tolist(),
            "numpy": lambda: x.numpy(), "cpu": lambda: x.cpu(),
            "np.asarray": lambda: np.asarray(x)}[way]
    with pytest.raises(HostTransferError):
        with transfer_sanitizer():
            read()


def test_fetch_budget_exceeded():
    a, b = torch.ones(3), torch.ones(3)
    with pytest.raises(FetchBudgetExceeded):
        with transfer_sanitizer(max_fetches=1):
            engine.host_read(a)
            engine.host_array(b)


def test_transfer_sanitizer_restores_patches():
    doors = (engine.host_read, engine.host_array)
    before = {name: torch.Tensor.__dict__.get(name) for name in GUARDED_METHODS}
    x = torch.ones(())
    with pytest.raises(HostTransferError):
        with transfer_sanitizer():
            x.item()
    with pytest.raises(ZeroDivisionError):
        with transfer_sanitizer():
            1 / 0
    assert (engine.host_read, engine.host_array) == doors
    assert {name: torch.Tensor.__dict__.get(name) for name in GUARDED_METHODS} == before
    assert float(x) == 1.0 and x.item() == 1.0 and np.asarray(x) == 1.0
    assert engine.host_read(torch.ones(2)) == [1.0, 1.0]


def test_traced_path_same_sanctioned_reads_as_untraced(problem):
    X, y = problem
    with transfer_sanitizer(max_fetches=400) as ts_off:
        off = _est().path(DenseDesign(X), y, path_len=PATH_LEN)
    with observe() as obs:
        with transfer_sanitizer(max_fetches=400) as ts_on:
            on = _est().path(DenseDesign(X), y, path_len=PATH_LEN)
    assert ts_on.fetches == ts_off.fetches
    assert torch.equal(on.betas, off.betas)
    assert any(r["name"] == "lambda_point" for r in obs.tracer.spans)


# ---------------------------------------------------------------------------
# compile sanitizer
# ---------------------------------------------------------------------------

@pytest.fixture
def stub_build(monkeypatch, tmp_path):
    """A build that compiles nothing: ``nvcc`` replaced by a stub that
    writes the library file, ``ctypes.CDLL`` by a stand-in."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_loaded", {})

    def fake_build_all(names=build.SOURCES):
        for name in names:
            build.lib_path(name).write_bytes(b"")
        return {name: 0.0 for name in names}

    monkeypatch.setattr(build, "build_all", fake_build_all)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: ("lib", path))


def test_compile_sanitizer_counts_a_stubbed_build(stub_build):
    with compile_sanitizer(2) as cs:
        build.load("gram_cd")
        build.load("gram_cd")                   # loaded: neither built nor loaded again
    assert cs.compiles == ["load:gram_cd", "build:gram_cd"]
    with compile_sanitizer(0) as cs:
        build.load("gram_cd")
    assert cs.count == 0
    with pytest.raises(CompileBudgetExceeded, match="load:slab_spmv, build:slab_spmv"):
        with compile_sanitizer(1):
            build.load("slab_spmv")
    # restored: a later load is not counted anywhere
    assert build.load.__module__ == build.__name__


def test_warm_path_needs_no_build(problem):
    X, y = problem
    _est().path(DenseDesign(X), y, path_len=4)
    with compile_sanitizer(0) as cs:
        _est().path(DenseDesign(X), y, path_len=4)
    assert cs.count == 0
