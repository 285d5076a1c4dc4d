"""The port's truncated-gradient baseline (``core/truncated_gradient.py``,
the plain version of the ``tg_pass`` kernel) against the JAX package on
the same numpy inputs.

The problem is ``small_glm``'s shape (2560 x 128 before the 20% test
split) drawn by numpy; both packages get the rows in the same order
(``key=None`` / ``generator=None``: JAX streams cannot be replayed).
Snapshots agree within rtol 1e-4 / atol 1e-6: at p = 128 the pass is
stable, so the two packages' different dot-product orders stay at
rounding level. Also: ``tg_pass_ref`` against a float64 numpy loop, its
margin's sum order against a lane-by-lane emulation of the kernel's, and
the reference's three TG properties on the port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TGOptions as JTGOptions
from repro.core import truncated_gradient_fit as j_tg_fit
from repro_torch.configs.base import GLMConfig
from repro_torch.core.objective import lambda_max, margins, objective
from repro_torch.core.truncated_gradient import TGOptions, truncated_gradient_fit
from repro_torch.core.truncated_gradient import shrink as tg_shrink
from repro_torch.data.synthetic import make_glm_dataset
from repro_torch.kernels import ops, ref, tg_pass

torch.set_num_threads(2)
INF = float("inf")


@pytest.fixture(scope="module")
def problem():
    ds = make_glm_dataset(GLMConfig(name="test", num_examples=2560, num_features=128),
                          np.random.default_rng(0), device="cpu")
    X, y = ds.X_train, ds.y_train
    return X.numpy(), y.numpy(), float(lambda_max(X, y))


@pytest.mark.parametrize("passes,theta,every,machines", [
    (1, INF, 1, 8), (3, INF, 1, 8), (3, 0.05, 2, 8), (4, 0.05, 2, 4)])
def test_snapshots_match_reference(problem, passes, theta, every, machines):
    X, y, lmax = problem
    lam = lmax / 64
    kw = dict(num_machines=machines, passes=passes, theta=theta)
    want = j_tg_fit(jnp.asarray(X), jnp.asarray(y), lam, opts=JTGOptions(**kw),
                    snapshot_every=every)
    got = truncated_gradient_fit(X, y, lam, opts=TGOptions(**kw), snapshot_every=every,
                                 device="cpu")
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, b), (_, b0) in zip(got, want):
        np.testing.assert_allclose(b.numpy(), np.asarray(b0), rtol=1e-4, atol=1e-6)


def _numpy_pass(Xs, ys, beta, eta, shrink, theta):
    """One pass per machine in float64, written from the paper's update."""
    out = []
    for Xm, ym in zip(Xs.astype(np.float64), ys.astype(np.float64)):
        b = beta.astype(np.float64).copy()
        for x, yi in zip(Xm, ym):
            g = 1.0 / (1.0 + np.exp(-(x @ b))) - (yi + 1.0) / 2.0
            b = b - eta * g * x
            shrunk = np.sign(b) * np.maximum(np.abs(b) - shrink, 0.0)
            b = np.where(np.abs(b) <= theta, shrunk, b)
        out.append(b)
    return np.stack(out)


@pytest.mark.parametrize("p,theta", [(700, INF), (700, 0.05), (40, 0.02)])
def test_tg_pass_ref_matches_float64_loop(p, theta):
    """Float32 against float64 over 60 steps: 1e-5 absolute (the update is
    O(eta |x|) per step and contracts rounding in the saturated margins)."""
    rng = np.random.default_rng(3)
    Xs = (0.1 * rng.standard_normal((3, 60, p))).astype(np.float32)
    ys = np.where(rng.random((3, 60)) < 0.5, 1.0, -1.0).astype(np.float32)
    beta = (0.05 * rng.standard_normal(p)).astype(np.float32)
    eta, shrink = 0.1, tg_shrink(0.1, 1e-3)
    got = ops.tg_pass(torch.from_numpy(Xs), torch.from_numpy(ys), torch.from_numpy(beta),
                      eta, shrink, theta)
    want = _numpy_pass(Xs, ys, beta, eta, shrink, theta)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert ops.launch_counts()["tg_pass"] == 0    # the plain version ran


def _kernel_margin(x, b):
    """The kernel's margin for one machine, lane by lane in float32: thread
    t sums its products k = 0, 1, ... in order; each warp folds by shuffles
    down (lane l += lane l + off, off = 16 ... 1); lane 0 of every warp
    reads the warps' sums (zeros past the last) and folds the same way."""
    T, f32 = tg_pass.THREADS, np.float32
    per = -(-len(x) // T)
    prod = np.zeros(per * T, f32)
    prod[:len(x)] = x.astype(f32) * b.astype(f32)
    lanes = [f32(prod[t]) for t in range(T)]
    for k in range(1, per):
        lanes = [f32(lanes[t] + prod[k * T + t]) for t in range(T)]

    def warp_fold(v):
        v = list(v)
        for off in (16, 8, 4, 2, 1):
            v = [f32(v[i] + v[i + off]) if i + off < 32 else v[i] for i in range(32)]
        return v[0]

    sums = [warp_fold(lanes[w * 32:(w + 1) * 32]) for w in range(T // 32)]
    return warp_fold(sums + [f32(0)] * (32 - len(sums)))


@pytest.mark.parametrize("p", [1, 37, 512, 2000, 4099])
def test_margin_sum_order_is_the_kernels(p):
    """The plain version's margin equals the kernel's sum order bit for bit
    (the pass is chaotic at epsilon's width, so the card is held to this
    order, not to a tolerance)."""
    rng = np.random.default_rng(p)
    x = rng.standard_normal((2, p)).astype(np.float32)
    b = rng.standard_normal((2, p)).astype(np.float32)
    got = ref.tg_margin(torch.from_numpy(x), torch.from_numpy(b)).numpy()
    want = np.array([_kernel_margin(x[m], b[m]) for m in range(2)], np.float32)
    np.testing.assert_array_equal(got, want)


def test_width_limit_is_typed():
    assert tg_pass.regs_per_thread(2000) == 4
    assert tg_pass.regs_per_thread(4099) == 16
    with pytest.raises(tg_pass.TGWidthError, match="8193"):
        tg_pass.regs_per_thread(tg_pass.MAX_P + 1)


def test_fit_takes_a_generator_and_reads_nothing(problem):
    """A shuffled fit is reproducible from its generator and leaves its
    snapshots as tensors (no host read between passes)."""
    from repro_torch.core import engine

    X, y, lmax = problem
    engine.host_syncs = 0
    a = truncated_gradient_fit(X, y, lmax / 16, opts=TGOptions(num_machines=4, passes=2),
                               generator=torch.Generator().manual_seed(7), device="cpu")
    b = truncated_gradient_fit(X, y, lmax / 16, opts=TGOptions(num_machines=4, passes=2),
                               generator=torch.Generator().manual_seed(7), device="cpu")
    assert engine.host_syncs == 0
    assert all(torch.is_tensor(s) and torch.equal(s, t) for (_, s), (_, t) in zip(a, b))


# the reference's three properties (tests/test_truncated_gradient.py), on the port

def test_tg_learns(problem):
    X, y, lmax = problem
    lam = lmax / 64
    snaps = truncated_gradient_fit(
        X, y, lam, opts=TGOptions(num_machines=8, passes=8, learning_rate=0.1, decay=0.5),
        generator=torch.Generator().manual_seed(0), device="cpu")
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    beta0 = torch.zeros(X.shape[1])
    f0 = float(objective(margins(Xt, beta0), yt, beta0, lam))
    f_end = float(objective(margins(Xt, snaps[-1][1]), yt, snaps[-1][1], lam))
    assert f_end < f0, (f_end, f0)


def test_tg_sparsity_increases_with_lambda(problem):
    X, y, lmax = problem
    nnz = []
    for lam in (lmax / 4, lmax / 64):
        snaps = truncated_gradient_fit(X, y, lam, opts=TGOptions(num_machines=4, passes=5),
                                       generator=torch.Generator().manual_seed(1),
                                       device="cpu")
        nnz.append(int((snaps[-1][1].abs() > 1e-8).sum()))
    assert nnz[0] <= nnz[1]


def test_tg_snapshots_every_pass(problem):
    X, y, _ = problem
    snaps = truncated_gradient_fit(X, y, 1.0, opts=TGOptions(num_machines=4, passes=3),
                                   generator=torch.Generator().manual_seed(2), device="cpu")
    assert [s[0] for s in snaps] == [1, 2, 3]
