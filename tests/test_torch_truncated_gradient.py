"""The port's truncated-gradient baseline (``core/truncated_gradient.py``,
the plain version of the ``tg_pass`` kernel) against the JAX package on
the same numpy inputs.

The problem is ``small_glm``'s shape (2560 x 128 before the 20% test
split) drawn by numpy; both packages get the rows in the same order
(``key=None`` / ``generator=None``: JAX streams cannot be replayed).
Snapshots agree within rtol 1e-4 / atol 1e-6: at p = 128 the pass is
stable, so the two packages' different dot-product orders stay at
rounding level. Also: ``tg_pass_ref`` against a float64 numpy loop, its
margin's sum order against a lane-by-lane emulation of the kernel's, its
float sigmoid against float64 (in ulps) and op by op against numpy, the
whole plain step against a numpy emulation of the kernel, and the
reference's three TG properties on the port.
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
    t holds the products of coordinates j = 4 (g T + t) + c (g < per / 4,
    c < 4; zeros past p) and folds them by adjacent pairs; LEVELS rounds of
    xor shuffles (lane l += lane l ^ o, o = 1, 2, ...) fold groups of
    2^LEVELS lanes; every lane stores its group's sum in slot t >> LEVELS
    of the 16 shared ones; each thread folds the 16 slots by adjacent
    pairs."""
    f32 = np.float32
    T, per = tg_pass.launch_shape(len(x))
    levels = int(np.log2(T // 16))

    def fold(v):
        v = list(v)
        w = 1
        while w < len(v):
            for n in range(0, len(v), 2 * w):
                v[n] = f32(v[n] + v[n + w])
            w *= 2
        return v[0]

    def coord(t, n):
        j = 4 * ((n // 4) * T + t) + n % 4
        return f32(x[j]) * f32(b[j]) if j < len(x) else f32(0)

    lanes = [fold([coord(t, n) for n in range(per)]) for t in range(T)]
    for lev in range(levels):
        o = 1 << lev
        lanes = [f32(lanes[t] + lanes[t ^ o]) for t in range(T)]
    slots = [None] * 16
    for t in range(T):
        g = t >> levels
        assert slots[g] is None or slots[g].view(np.int32) == lanes[t].view(np.int32)
        slots[g] = lanes[t]
    return fold(slots)


@pytest.mark.parametrize("p", [1, 37, 512, 2000, 4099, 8192])
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


def _margins(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.uniform(-1, 1, 20000), rng.uniform(-20, 20, 40000), rng.uniform(-110, 110, 40000),
        np.linspace(-110, 110, 20001),
        [0.0, -0.0, 1e-30, -1e-30, 87.0, -87.0, 103.97, -103.97, -103.97207641601562,
         -103.97208404541016, -104.0, -200.0, 200.0, 1e30, -1e30]]).astype(np.float32)


def test_tg_sigmoid_within_3_ulps():
    """The kernel's float sigmoid is at most 3 ulps from the correctly
    rounded float32 value of 1 / (1 + exp(-m)) (taken in float64) at every
    margin a pass can see, subnormal results and the 0 / 1 tails included."""
    m = _margins(5)
    got = ref.tg_sigmoid(torch.from_numpy(m)).numpy()
    with np.errstate(over="ignore"):
        want = (1.0 / (1.0 + np.exp(-m.astype(np.float64)))).astype(np.float32)
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 3, (ulps.max(), m[np.argmax(ulps)])
    assert np.mean(ulps == 0) > 0.6


def _numpy_sigmoid(m):
    """``csrc/tg_pass.cu``'s tg_sigmoid op for op in numpy float32."""
    f32 = np.float32
    c = [f32(v) for v in ref.TG_POLY]
    x = np.maximum(-np.abs(m), f32(ref.TG_X_CLAMP))
    k = np.rint(x * f32(ref.TG_L2E))
    r = (x - k * f32(ref.TG_LN2_HI)) - k * f32(ref.TG_LN2_LO)
    r2 = r * r
    a0, a1, a2 = c[0] + c[1] * r, c[2] + c[3] * r, c[4] + c[5] * r
    r4 = r2 * r2
    q = (a0 + a1 * r2) + (a2 + c[6] * r2) * r4
    ki = k.astype(np.int32)
    nb = np.maximum(ki + 127, 0) << 23
    sb = np.left_shift(np.int32(1), np.clip(ki + 149, 0, 30)).astype(np.int32)
    e = q * np.where(ki >= -126, nb, sb).astype(np.int32).view(f32)
    num = np.where(m >= 0, f32(1), np.where(m <= -f32(ref.TG_M_ZERO), f32(0), e))
    return (num / (f32(1) + e)).astype(f32)


def test_tg_sigmoid_is_the_kernels_float_sequence():
    m = _margins(6)
    got = ref.tg_sigmoid(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), _numpy_sigmoid(m).view(np.int32))


@pytest.mark.parametrize("p,theta", [(37, INF), (37, 0.05), (600, INF)])
def test_plain_pass_is_the_numpy_emulation(p, theta):
    """``tg_pass_ref`` step by step against an emulation of the kernel in
    numpy float32: the lane-by-lane margin, the float sigmoid, c = eta g
    once, beta - c x and the truncation; bit for bit over 12 steps."""
    f32 = np.float32
    rng = np.random.default_rng(p)
    Xs = rng.standard_normal((2, 12, p)).astype(f32)
    ys = np.where(rng.random((2, 12)) < 0.5, 1.0, -1.0).astype(f32)
    beta = (0.3 * rng.standard_normal(p)).astype(f32)
    eta, shrink = f32(0.5), f32(tg_shrink(0.5, 2e-2))
    got = ref.tg_pass_ref(torch.from_numpy(Xs), torch.from_numpy(ys), torch.from_numpy(beta),
                          float(eta), float(shrink), theta).numpy()
    for m in range(2):
        b = beta.copy()
        for x, y in zip(Xs[m], ys[m]):
            margin = np.array([_kernel_margin(x, b)], f32)
            c = eta * (_numpy_sigmoid(margin)[0] - (y + f32(1)) * f32(0.5))
            bb = b - c * x
            trunc = np.copysign(np.maximum(np.abs(bb) - shrink, f32(0)), bb)
            b = np.where(np.abs(bb) <= f32(theta), trunc, bb).astype(f32)
        np.testing.assert_array_equal(got[m].view(np.int32), b.view(np.int32))


def test_width_limit_is_typed():
    assert tg_pass.launch_shape(2000) == (128, 16)
    assert tg_pass.launch_shape(4099) == (256, 32)
    assert tg_pass.launch_shape(8192) == (256, 32)
    with pytest.raises(tg_pass.TGWidthError, match="8193"):
        tg_pass.launch_shape(tg_pass.MAX_P + 1)


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
