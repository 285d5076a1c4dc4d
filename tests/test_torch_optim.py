"""The port's optimizers, clipping and schedules (``repro_torch.optim``)
against the JAX package's (``repro.optim``) on the same numpy inputs.

The tree has leaves the reference stacks on a leading layer axis (3-D
and 2-D, float32 and bfloat16), a plain 2-D bfloat16 leaf, a 1-D leaf and
a scalar. The port holds each stacked leaf as a ``Stacked`` of per-layer
tensors, as ``train.state.param_tree`` holds a segment's weights. Each
case runs 1 and 3 updates in both packages and compares the updates, the
weights and every state leaf. Tolerances: rtol 1e-6 on float32 values,
plus an atol of 1e-6 of the array's largest magnitude (an AdamW update
``-lr (step + wd p)`` can cancel to near 0); one bfloat16 ulp on bfloat16
weights. Inputs are normal draws, far from the subnormal range, and the
denormal flush is on as XLA's CPU backend has it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adafactor as j_adafactor
from repro.optim import adamw as j_adamw
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import constant as j_constant
from repro.optim import sgd as j_sgd
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.optim.optimizers import apply_updates as j_apply_updates
from repro_torch.optim import (Stacked, adafactor, adamw, apply_updates, clip_by_global_norm,
                               constant, make_optimizer, sgd, warmup_cosine)
from repro_torch.optim.optimizers import tree_map

L = 3
#: name -> (shape, dtype, stacked over the layer axis in the reference)
LEAVES = {
    "w3": ((L, 4, 5), "float32", True),
    "wb": ((L, 6, 4), "bfloat16", True),
    "s1": ((L, 8), "float32", True),       # a stack of (d,) norm scales
    "w2": ((6, 7), "bfloat16", False),
    "v1": ((9,), "float32", False),
    "sc": ((), "float32", False),
}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _flush_denormals():
    """Flush subnormals as XLA's CPU backend does, for this module's tests
    only: the flag is process state, and later tests in the same worker
    (hypothesis's float strategies) refuse to run under it."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _draw(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(scale * rng.standard_normal(shape), dtype=np.float32)
            for k, (shape, _, _) in LEAVES.items()}


def _jtree(arrays):
    return {k: jnp.asarray(a, dtype=jnp.dtype(LEAVES[k][1])) for k, a in arrays.items()}


def _ttree(arrays):
    out = {}
    for k, a in arrays.items():
        t = torch.from_numpy(a).to(TDT[LEAVES[k][1]])
        out[k] = Stacked(t.unbind(0)) if LEAVES[k][2] else t
    return out


def _np(x):
    """A port leaf (Stacked stacked) or a reference array as float32 numpy."""
    if isinstance(x, Stacked):
        x = x.stack()
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    atol = 1e-6 * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol, err_msg=what)


def _within_bf16_ulp(got, want, what):
    got, want = _np(got), _np(want)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert (np.abs(got - want) <= ulp).all(), (what, float(np.abs(got - want).max()))


def _state_leaves(state):
    """(path, leaf) pairs of a state tree, in sorted-key order."""
    if isinstance(state, dict):
        return [(f"[{k!r}]{p}", x) for k in sorted(state) for p, x in _state_leaves(state[k])]
    return [("", state)]


CASES = {
    "sgd": (lambda: j_sgd(momentum=0.9, weight_decay=0.01),
            lambda: sgd(momentum=0.9, weight_decay=0.01)),
    "adamw": (lambda: j_adamw(), lambda: adamw()),
    "adafactor": (lambda: j_adafactor(weight_decay=0.01), lambda: adafactor(weight_decay=0.01)),
}


@pytest.mark.parametrize("n_updates", [1, 3])
@pytest.mark.parametrize("name", sorted(CASES))
def test_updates_and_state_match_the_reference(name, n_updates):
    jopt, topt = (make() for make in CASES[name])
    p0 = _draw(0)
    jp, tp = _jtree(p0), _ttree(p0)
    jst, tst = jopt.init(jp), topt.init(tp)
    for i in range(n_updates):
        g = _draw(10 + i, scale=0.1 * (i + 1))
        lr = 1e-2 * (i + 1)
        jupd, jst = jopt.update(_jtree(g), jst, jp, jnp.float32(lr))
        tupd, tst = topt.update(_ttree(g), tst, tp, torch.tensor(lr, dtype=torch.float32))
        for k in LEAVES:
            _close(tupd[k], jupd[k], f"{name} update {i} of {k}")
        jp = j_apply_updates(jp, jupd)
        tp = apply_updates(tp, tupd)
    for k, (_, dt, _) in LEAVES.items():
        if dt == "bfloat16":
            assert (tp[k][0] if LEAVES[k][2] else tp[k]).dtype == torch.bfloat16
            _within_bf16_ulp(tp[k], jp[k], f"{name} weight {k}")
        else:
            _close(tp[k], jp[k], f"{name} weight {k}")
    jl, tl = _state_leaves(jst), _state_leaves(tst)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, j), (_, t) in zip(jl, tl):
        if path.endswith("['count']"):
            assert int(t) == int(j) == n_updates
            continue
        assert (t[0] if isinstance(t, Stacked) else t).dtype == torch.float32, path
        _close(t, j, f"{name} state {path}")


def test_adafactor_factors_the_stacked_leaf():
    """A stack of (d,) scales is one (L, d) leaf: its accumulators are
    (L,) and (d,), as the reference's, and factoring each layer's (d,)
    on its own (unfactored, RMS per layer) gives another update."""
    p0, g = _draw(0), _draw(1, scale=0.3)
    st = adafactor().init(_ttree(p0))
    assert tuple(st["acc"]["s1"]["vr"].shape) == (L,)
    assert tuple(st["acc"]["s1"]["vc"].shape) == (8,)
    assert tuple(st["acc"]["w3"]["vr"].shape) == (L, 4)
    upd, _ = adafactor().update(_ttree(g), st, _ttree(p0), 0.1)
    jst = j_adafactor().init(_jtree(p0))
    jupd, _ = j_adafactor().update(_jtree(g), jst, _jtree(p0), jnp.float32(0.1))
    _close(upd["s1"], jupd["s1"], "stacked scale update")
    per_layer = {f"s1_{j}": torch.from_numpy(p0["s1"][j]) for j in range(L)}
    naive_st = adafactor().init(per_layer)
    naive, _ = adafactor().update({k: torch.from_numpy(g["s1"][j])
                                   for j, k in enumerate(per_layer)}, naive_st, per_layer, 0.1)
    naive = np.stack([naive[f"s1_{j}"].numpy() for j in range(L)])
    assert np.abs(naive - _np(jupd["s1"])).max() > 1e-3


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm(max_norm):
    g = _draw(3)
    jg, jn = j_clip(_jtree(g), max_norm)
    tg, tn = clip_by_global_norm(_ttree(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert tn.dtype == torch.float32
    for k in LEAVES:
        leaf = tg[k][0] if isinstance(tg[k], Stacked) else tg[k]
        assert leaf.dtype == torch.float32, k         # bf16 * f32 scale -> f32, as jnp
        assert jg[k].dtype == jnp.float32
        _close(tg[k], jg[k], f"clipped {k}")


def test_warmup_cosine_every_step():
    peak, warm, total = 3e-4, 3, 17
    j, t = j_warmup_cosine(peak, warm, total), warmup_cosine(peak, warm, total)
    for s in range(total + 3):
        want = np.float32(j(jnp.int32(s)))
        got = t(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - float(want)) <= float(np.spacing(want)), (s, float(got), want)
    assert float(constant(1e-3)(torch.tensor(5))) == float(j_constant(1e-3)(5))


def test_make_optimizer_names():
    for name in ("sgd", "adamw", "adafactor"):
        assert callable(make_optimizer(name).update)
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("lamb")


def test_tree_map_keeps_stacked_leaves():
    tree = {"a": Stacked((torch.ones(2), torch.zeros(2))), "b": [torch.ones(())]}
    out = tree_map(lambda x: x, tree)
    assert isinstance(out["a"], Stacked) and out["a"].shape == (2, 2)
    assert isinstance(out["b"], list)
