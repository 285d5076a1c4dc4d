"""The port's LM training path (``repro_torch.train``: the train state, the
loss and the training step; ``api.convert``'s train-state conversions; the
launcher) against the JAX package on the same numpy inputs.

Every step runs tinyllama's ``smoke()`` model (2 layers, d_model 256,
float32, remat off) from the reference's own initial state carried
across by ``train_state_from_reference``, on batches cut from one numpy
Zipf corpus, under ``warmup_cosine``. Tolerance for losses, grad norms,
learning rates, weights and moments after 3 steps: rtol 1e-4, atol 1e-5
(float32 sums in another order than XLA's). The configuration the card
trains (bf16 weights and activations, remat, microbatches) is held to
the bf16 bounds of ``_assert_bf16_run_close``, and its accumulation and
update cast bit for bit on the port's own gradients. Denormals are
flushed, as XLA's CPU backend flushes them.
"""
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as j_load_pytree
from repro.configs import MODEL_CONFIGS as J_CONFIGS
from repro.models.attention import _sdpa_jnp
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.optim.optimizers import apply_updates as j_apply_updates
from repro.train import cross_entropy as j_cross_entropy
from repro.train import make_train_state as j_make_train_state
from repro.train import make_train_step as j_make_train_step
from repro.train import train_state_shapes as j_train_state_shapes
from repro_torch.api.convert import (reference_tree, train_state_from_reference,
                                     train_state_to_reference)
from repro_torch.checkpoint.checkpointer import _flatten
from repro_torch.configs import MODEL_CONFIGS
from repro_torch.data.lm_data import zipf_corpus
from repro_torch.kernels import ops
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.optim import constant, warmup_cosine
from repro_torch.optim.optimizers import tensors
from repro_torch.train import (IGNORE, cross_entropy, make_train_state, make_train_step,
                               train_state_shapes)
from repro_torch.train import train_step as tstep
from repro_torch.train.state import param_tree

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
ARCH = "tinyllama-1.1b"
RTOL, ATOL = 1e-4, 1e-5
#: bf16 runs: loss, ce and grad norm (1.5e-4 measured); the weights' share
#: beyond one bf16 ulp (2% measured); the float32 moments against their
#: leaf's largest magnitude (1.3% measured)
BF16_METRIC_RTOL, BF16_OFF_ULP_SHARE, BF16_MOMENT_TOL = 1e-3, 0.05, 0.05
STEPS, BATCH, SEQ = 3, 4, 32
PEAK_LR = 1e-3


@pytest.fixture(autouse=True)
def _flush_denormals():
    """Flush subnormals as XLA's CPU backend does, for this module's tests
    only: the flag is process state, and later tests in the same worker
    (hypothesis's float strategies) refuse to run under it."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t, jnp.float32))


def _batches(vocab, n=STEPS):
    corpus = zipf_corpus(np.random.default_rng(0), vocab, 20_000)
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n):
        s = int(rng.integers(0, len(corpus) - BATCH * (SEQ + 1)))
        w = corpus[s:s + BATCH * (SEQ + 1)].reshape(BATCH, SEQ + 1)
        out.append({"tokens": w[:, :-1].copy(), "labels": w[:, 1:].copy()})
    return out


def _reference_run(jcfg, batches):
    state = j_make_train_state(jax.random.key(0), jcfg)
    init = jax.tree.map(np.asarray, state)
    step = jax.jit(j_make_train_step(jcfg, lr_schedule=j_warmup_cosine(PEAK_LR, 1, STEPS)))
    metrics = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return init, jax.tree.map(np.asarray, state), metrics


def _port_run(tcfg, init, batches):
    state = train_state_from_reference(init, tcfg, device="cpu")
    step = make_train_step(tcfg, lr_schedule=warmup_cosine(PEAK_LR, 1, STEPS))
    metrics = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _assert_trees_close(got, want, what, rtol=RTOL, atol=ATOL):
    g, w = _flatten(got), _flatten(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {path}")


def _assert_bf16_run_close(got, want, lr_sum):
    """A bf16 run against the reference's. Both round every bf16 result,
    in another order, so the gradients differ by about 1e-4 relative, and
    AdamW's normalised step (about lr in size early on) takes the other
    sign wherever a gradient element is near 0. So every weight lies
    within one bf16 ulp (rtol 2^-7) plus 2 * sum(lr), the most steps of
    the other sign move it, and at most ``BF16_OFF_ULP_SHARE`` of a
    weight's elements lie beyond one ulp; float32 moments lie within
    ``BF16_MOMENT_TOL`` of their leaf's largest magnitude; counters agree."""
    g, w = _flatten(got), _flatten(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
        if path.startswith("['params']"):
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 2.0 ** -126))) - 7)
            share = float((np.abs(a - b) > ulp).mean())
            assert share <= BF16_OFF_ULP_SHARE, f"{path}: {share} beyond one bf16 ulp"
            np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=2 * lr_sum, err_msg=path)
        elif b.size > 1:
            err = float(np.abs(a - b).max() / np.abs(b).max())
            assert err <= BF16_MOMENT_TOL, f"{path}: {err} of the leaf's largest magnitude"
        else:
            assert np.array_equal(a, b), path


VARIANTS = {
    "adamw": {},
    "microbatch2": {"microbatch": 2},
    "adafactor": {"optimizer": "adafactor"},
    # the configuration the card trains: bf16 weights and activations, remat
    "bf16_remat_microbatch2": {"param_dtype": "bfloat16", "compute_dtype": "bfloat16",
                               "remat": True, "microbatch": 2},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_three_steps_match_the_reference(variant):
    jcfg = replace(J_CONFIGS[ARCH].smoke(), **VARIANTS[variant])
    tcfg = replace(MODEL_CONFIGS[ARCH].smoke(), **VARIANTS[variant])
    batches = _batches(tcfg.vocab_size)
    init, jfinal, jm = _reference_run(jcfg, batches)
    state, tm = _port_run(tcfg, init, batches)
    bf16 = tcfg.param_dtype == "bfloat16"
    for i, (a, b) in enumerate(zip(tm, jm)):
        for k in ("loss", "ce", "ntok", "grad_norm", "lr"):
            rtol = BF16_METRIC_RTOL if bf16 and k in ("loss", "ce", "grad_norm") else RTOL
            np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=ATOL,
                                       err_msg=f"step {i} {k}")
    assert tm[-1]["loss"] < tm[0]["loss"]
    if bf16:
        _assert_bf16_run_close(train_state_to_reference(state), jfinal,
                               sum(m["lr"] for m in jm))
    else:
        _assert_trees_close(train_state_to_reference(state), jfinal, variant)
    assert int(state["step"]) == STEPS


def test_card_config_accumulates_and_updates_as_the_reference(monkeypatch):
    """What the bf16 comparison above cannot resolve, at the configuration
    the card trains, bit for bit against the JAX package's formulas on the
    port's own microbatch gradients: the gradients accumulate in the
    parameter type (``grads + g / n`` in bf16, not float32), and the update
    is cast to bf16 before it is added (``p + u.astype(p.dtype)``). Four
    microbatches, so that a sum kept in float32 and rounded once at the
    end gives other bits than a sum rounded at each step, as each check
    also shows."""
    cfg = replace(MODEL_CONFIGS[ARCH].smoke(), **dict(VARIANTS["bf16_remat_microbatch2"],
                                                      microbatch=4))
    state = make_train_state(torch.Generator().manual_seed(5), cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg.vocab_size, 1)[0].items()}
    leaves = tensors(param_tree(state["params"]))
    half = BATCH // cfg.microbatch
    micro = []
    for i in range(cfg.microbatch):
        with torch.enable_grad():
            loss, _ = tstep.make_loss_fn(cfg)(
                state["params"], {k: v[i * half:(i + 1) * half] for k, v in batch.items()})
            micro.append(torch.autograd.grad(loss, leaves))
    seen = {}
    clip, apply = tstep.clip_by_global_norm, tstep.apply_updates

    def seen_clip(grads, max_norm):
        seen["grads"] = [g.clone() for g in tensors(grads)]
        return clip(grads, max_norm)

    def seen_apply(params, updates):
        seen["before"] = [p.detach().clone() for p in tensors(params)]
        seen["updates"] = [u.clone() for u in tensors(updates)]
        return apply(params, updates)

    monkeypatch.setattr(tstep, "clip_by_global_norm", seen_clip)
    monkeypatch.setattr(tstep, "apply_updates", seen_apply)
    make_train_step(cfg, lr_schedule=constant(1e-3))(state, batch)

    def bf16(t):
        return jnp.asarray(t.detach().float().numpy()).astype(jnp.bfloat16)

    def bits(a):
        return np.asarray(jnp.asarray(a, jnp.float32))

    acc = [jnp.zeros(g.shape, jnp.bfloat16) for g in micro[0]]
    acc32 = [jnp.zeros(g.shape, jnp.float32) for g in micro[0]]
    for g in micro:
        acc = [x + bf16(y) / cfg.microbatch for x, y in zip(acc, g)]
        acc32 = [x + bf16(y).astype(jnp.float32) / cfg.microbatch for x, y in zip(acc32, g)]
    assert all(g.dtype == torch.bfloat16 for g in seen["grads"])
    for got, want in zip(seen["grads"], acc):
        assert np.array_equal(_np(got), bits(want))
    assert any(not np.array_equal(bits(a), bits(a32.astype(jnp.bfloat16)))
               for a, a32 in zip(acc, acc32))
    before = [bf16(p) for p in seen["before"]]
    upd = [jnp.asarray(u.numpy()) for u in seen["updates"]]
    want = j_apply_updates(before, upd)
    after = tensors(param_tree(state["params"]))
    assert all(p.dtype == torch.bfloat16 for p in after)
    for got, w in zip(after, want):
        assert np.array_equal(_np(got), bits(w))
    assert any(not np.array_equal(bits(w), bits((b.astype(jnp.float32) + u).astype(jnp.bfloat16)))
               for w, b, u in zip(want, before, upd))


def test_remat_changes_no_value():
    """Remat on (each layer checkpointed) against off, inside the port:
    the same losses and weights, bit for bit on the CPU."""
    cfg = MODEL_CONFIGS[ARCH].smoke()
    batches = _batches(cfg.vocab_size)
    init = train_state_to_reference(make_train_state(torch.Generator().manual_seed(3), cfg,
                                                     device="cpu"))
    runs = [_port_run(replace(cfg, remat=r), init, batches) for r in (False, True)]
    assert [m["loss"] for m in runs[0][1]] == [m["loss"] for m in runs[1][1]]
    for (pa, a), (_, b) in zip(_flatten(reference_tree(runs[0][0])),
                               _flatten(reference_tree(runs[1][0]))):
        assert torch.equal(a, b), pa


def test_remat_checkpoints_each_layer(monkeypatch):
    """With ``cfg.remat`` the training forward runs every layer through
    ``checkpoint``; serving modes and frozen weights never do."""
    from repro_torch.models import transformer

    calls = []
    real = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = replace(MODEL_CONFIGS[ARCH].smoke(), remat=True)
    state = make_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg.vocab_size, 1)[0].items()}
    make_train_step(cfg)(state, batch)
    assert len(calls) == cfg.num_layers
    transformer.lm_forward(state["params"], batch, cfg, mode="prefill")
    with torch.no_grad():
        transformer.lm_forward(state["params"], batch, cfg, mode="train")
    assert len(calls) == cfg.num_layers


def test_chunked_attention_gradient_matches_the_reference():
    """The chunked path's gradient with its chunk body checkpointed, against
    the reference's ``_sdpa_jnp`` (its body under ``jax.checkpoint``) and
    against the one-block path."""
    rng = np.random.default_rng(4)
    b, s, h, hk, dh, chunk = 2, 64, 4, 2, 16, 16
    q, k, v = (rng.standard_normal((b, s, n, dh)).astype(np.float32) for n in (h, hk, hk))
    w = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))

    def jloss(q, k, v):
        o = _sdpa_jnp(q, k, v, pos, pos, scale=dh ** -0.5, q_chunk=chunk)
        return jnp.sum(o * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    for q_chunk in (chunk, 1024):
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        tpos = torch.from_numpy(pos.copy())
        o = tattn._sdpa_torch(tq, tk, tv, tpos, tpos, scale=dh ** -0.5, q_chunk=q_chunk)
        (o * torch.from_numpy(w)).sum().backward()
        for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cross_entropy_matches_the_reference():
    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[rng.random((3, 7)) < 0.3] = IGNORE
    for lab in (labels, np.full_like(labels, IGNORE)):
        jce, jn = j_cross_entropy(jnp.asarray(logits), jnp.asarray(lab))
        tl = torch.from_numpy(logits).requires_grad_()
        tce, tn = cross_entropy(tl, torch.from_numpy(lab))
        np.testing.assert_allclose(float(tce.detach()), float(jce), rtol=1e-6)
        assert int(tn) == int(jn) and tn.dtype == torch.int32
        tce.backward()
        jgrad = jax.grad(lambda x: j_cross_entropy(x, jnp.asarray(lab))[0])(jnp.asarray(logits))
        np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-8)
    assert int(j_cross_entropy(jnp.asarray(logits), jnp.full((3, 7), IGNORE))[1]) == 1


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor", "sgd"])
def test_state_shapes_are_the_references_once_stacked(optimizer):
    """``train_state_shapes`` allocates nothing (meta tensors) and, its
    per-layer leaves stacked, has the reference's leaves: the full-width
    model and the smoke one."""
    for base in (J_CONFIGS[ARCH], J_CONFIGS[ARCH].smoke()):
        jcfg = replace(base, optimizer=optimizer)
        tcfg = replace(MODEL_CONFIGS[ARCH] if base is J_CONFIGS[ARCH]
                       else MODEL_CONFIGS[ARCH].smoke(), optimizer=optimizer)
        shapes = train_state_shapes(tcfg)
        assert all(t.is_meta for t in shapes["params"].parameters())
        assert all(p.requires_grad for p in shapes["params"].parameters())
        got = [(p, tuple(t.shape), str(t.dtype).removeprefix("torch."))
               for p, t in _flatten(reference_tree(shapes))]
        want = [(jax.tree_util.keystr(p), tuple(s.shape), str(s.dtype))
                for p, s in jax.tree_util.tree_flatten_with_path(j_train_state_shapes(jcfg))[0]]
        assert got == want


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor", "sgd"])
def test_train_state_round_trip(optimizer):
    """reference -> port -> reference is the identity; a missing leaf raises."""
    jcfg = replace(J_CONFIGS[ARCH].smoke(), optimizer=optimizer)
    tcfg = replace(MODEL_CONFIGS[ARCH].smoke(), optimizer=optimizer)
    ref = jax.tree.map(np.asarray, j_make_train_state(jax.random.key(1), jcfg))
    back = train_state_to_reference(train_state_from_reference(ref, tcfg, device="cpu"))
    _assert_trees_close(back, ref, optimizer, rtol=0, atol=0)
    ref["opt"] = dict(ref["opt"])
    ref["opt"].pop(next(iter(ref["opt"])))
    with pytest.raises(ValueError, match="reference keys"):
        train_state_from_reference(ref, tcfg, device="cpu")


def test_training_never_reaches_the_flash_kernel():
    """The flash kernel is forward-only: its CUDA wrapper refuses an operand
    that requires grad (checked before anything touches the card), and a
    training step launches it 0 times."""
    flash = __import__("repro_torch.kernels.flash_attention", fromlist=["x"])
    q = torch.zeros(1, 64, 2, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash.flash_attention_kernel(q, q.detach(), q.detach())
    # the CPU dispatch still takes the plain version, autograd and all
    out = ops.flash_attention(q, q.detach(), q.detach())
    assert out.requires_grad
    cfg = MODEL_CONFIGS[ARCH].smoke()
    state = make_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    ops.reset_launch_counts()
    make_train_step(cfg)(state, {k: torch.from_numpy(v)
                                 for k, v in _batches(cfg.vocab_size, 1)[0].items()})
    assert ops.launch_counts()["flash_attention"] == 0


def _like(jcfg):
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), j_train_state_shapes(jcfg))


def test_launcher_checkpoint_loads_in_the_reference(tmp_path):
    """``launch.train --ckpt DIR`` writes the reference's layout: the JAX
    package's ``load_pytree`` reads it back equal to
    ``train_state_to_reference`` of the launcher's final state."""
    d = tmp_path / "ckpt"
    state = tlaunch.main(["--arch", ARCH, "--smoke", "--steps", "4", "--batch", "2", "--seq",
                          "64", "--device", "cpu", "--ckpt", str(d)])
    loaded = j_load_pytree(str(d), _like(J_CONFIGS[ARCH].smoke()))
    _assert_trees_close(loaded, train_state_to_reference(state), "checkpoint", rtol=0, atol=0)
    assert int(loaded["step"]) == 4


def test_launcher_runs_as_a_module(tmp_path):
    d = tmp_path / "ckpt"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
                        "--smoke", "--steps", "4", "--batch", "2", "--seq", "64", "--device",
                        "cpu", "--ckpt", str(d)], env=env, capture_output=True, text=True,
                       timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("step ")]
    assert [ln.split()[1] for ln in lines] == ["0", "1", "2", "3"]
    loaded = j_load_pytree(str(d), _like(J_CONFIGS[ARCH].smoke()))
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(loaded))
