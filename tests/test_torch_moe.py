"""The port's MoE slice (llama4-scout-17b-a16e) on the CPU, against the JAX
package on the same weights and inputs.

Weights cross over as numpy arrays: the reference draws them from its key
and ``api.convert.lm_params_from_reference`` loads them into the port's
modules (the nested ``moe.shared.*`` leaves and the stacked (L, E, d, f)
expert leaves included). Inputs are drawn once from a numpy seed and fed
to both packages. Tolerances: the routing (``expert_idx``, ``pos``,
``keep``, ``buf_idx``) equal exactly, the layer's output within atol =
rtol = 1e-5 (float32 products summed in another order than XLA's), its
auxiliary losses within 1e-6 relative, the smoke model's prefill logits
within 1e-4 (``tests/test_torch_lm.py``'s bound), greedy tokens equal;
three training steps within ``tests/test_torch_train.py``'s rtol 1e-4 /
atol 1e-5. The bf16-weights / float32-activations case (ROADMAP queue 3)
is held here for tinyllama and llama4.
"""
import dataclasses
import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MODEL_CONFIGS as J_CONFIGS
from repro.models import init_cache as j_init_cache
from repro.models import init_params
from repro.models.moe import _route_group
from repro.models.moe import capacity as j_capacity
from repro.models.moe import moe_forward
from repro.models.params import count_params_analytic as j_count_params
from repro.models.params import forward
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.train import make_prefill_step as j_make_prefill_step
from repro.train import make_serve_step as j_make_serve_step
from repro.train import make_train_state as j_make_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch.api import lm_params_from_reference
from repro_torch.api.convert import train_state_from_reference
from repro_torch.configs import MODEL_CONFIGS, get_config
from repro_torch.data.lm_data import zipf_corpus
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import count_params_analytic, param_bytes
from repro_torch.models import forward as t_forward
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.optim import warmup_cosine
from repro_torch.train import make_train_step

# the reference's functions compiled once per configuration: eager JAX
# compiles every op anew for each shape
j_route_group = jax.jit(_route_group, static_argnums=(2, 3))
j_moe_forward = jax.jit(moe_forward, static_argnames=("cfg", "deterministic"))
j_forward = jax.jit(forward, static_argnums=(2,), static_argnames=("mode",))

torch.set_num_threads(2)
ARCH = "llama4-scout-17b-a16e"
ROUTE_NAMES = ("logits", "probs", "gate_vals", "expert_idx", "pos", "keep", "buf_idx")
EXACT = ("expert_idx", "pos", "keep", "buf_idx")
MOE_TOL = 1e-5
AUX_RTOL = 1e-6
#: the drop fraction 1 - mean(keep) near 0: XLA's mean of booleans can
#: round 1 by an ulp (measured -1.49e-08 where the port gives 0)
AUX_ATOL = 2.0 ** -23
LOGIT_TOL = 1e-4
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-5


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


def _model(**over):
    """(reference cfg, port cfg, reference params, port LM) of llama4's
    smoke model, with the config fields ``over``."""
    jcfg = replace(J_CONFIGS[ARCH].smoke(), **over)
    tcfg = replace(MODEL_CONFIGS[ARCH].smoke(), **over)
    jp = init_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jp, lm_params_from_reference(jax.tree.map(np.asarray, jp), tcfg,
                                                    device="cpu")


@pytest.fixture(scope="module")
def smoke():
    return _model()


def prompts(batch, plen, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (batch, plen)).astype(np.int32)


def test_configs_match_reference():
    for arch in (ARCH, "mamba2-2.7b"):
        for full in (False, True):
            j = J_CONFIGS[arch] if full else J_CONFIGS[arch].smoke()
            t = get_config(arch) if full else get_config(arch).smoke()
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            assert t.padded_vocab == j.padded_vocab and t.layer_kinds() == j.layer_kinds()
    assert get_config(ARCH).padded_vocab == 202_240
    assert get_config("mamba2-2.7b").ssm.num_heads(2560) == 80


@pytest.mark.parametrize("tokens", [1, 7, 8, 48, 100, 1000, 16_384, 16_385])
@pytest.mark.parametrize("moe", [{}, {"top_k": 2, "capacity_factor": 0.5},
                                 {"num_experts": 3, "capacity_factor": 2.0}],
                         ids=["llama4", "top2_cf0.5", "e3_cf2"])
def test_capacity_matches_reference(tokens, moe):
    jm = replace(J_CONFIGS[ARCH].moe, **moe)
    tm = replace(MODEL_CONFIGS[ARCH].moe, **moe)
    assert tmoe.capacity(tokens, tm) == j_capacity(tokens, jm)
    assert tmoe.capacity(16_384, MODEL_CONFIGS[ARCH].moe) == 1280


@functools.lru_cache(maxsize=4)           # the three full configs
def _reference_shapes(jcfg):
    shapes = jax.eval_shape(lambda k: init_params(k, jcfg), jax.random.key(0))
    return [(jax.tree_util.keystr(path), leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]]


def _reference_counts(jcfg, wrap: bool):
    """(total, active) from the reference's own leaf shapes
    (``jax.eval_shape`` of its init) and its weighting rule
    (``repro/models/params.py`` ``count_params_analytic``), the leaf sizes
    as Python integers, or wrapped to int32 as its ``jnp.prod`` computes
    them when ``wrap``."""
    frac = jcfg.moe.top_k / jcfg.moe.num_experts if jcfg.moe.enabled else 1.0
    total = active = 0
    for name, shape in _reference_shapes(jcfg):
        size = int(np.prod(shape, dtype=np.int64))
        if wrap:
            size = (size + 2 ** 31) % 2 ** 32 - 2 ** 31
        expert = any(w in name for w in ("w_gate", "w_up", "w_down")) and (
            "moe" in name and "shared" not in name)
        total += size
        active += int(size * (frac if expert else 1.0))
    return total, active


@pytest.mark.parametrize("arch", [ARCH, "mamba2-2.7b", "tinyllama-1.1b"])
def test_param_counts_match_reference(arch):
    """Total and active counts of the full configs, built on the meta
    device, against the reference's leaf shapes under its weighting rule.
    The reference's own ``count_params_analytic`` takes each leaf's size
    as a ``jnp.prod`` in int32, which wraps for llama4's stacked (48, 16,
    5120, 8192) expert leaves (2^35 elements): its number is exactly the
    wrapped sum, and equals the port's where no leaf reaches 2^31."""
    cfg, jcfg = get_config(arch), J_CONFIGS[arch]
    total = count_params_analytic(cfg)
    active = count_params_analytic(cfg, active_only=True)
    assert (total, active) == _reference_counts(jcfg, wrap=False)
    assert total == cfg.num_params() and active == cfg.num_active_params()
    assert (j_count_params(jcfg), j_count_params(jcfg, active_only=True)) == _reference_counts(
        jcfg, wrap=True)
    assert param_bytes(cfg) == 2 * total
    if arch == ARCH:
        assert (total, active) == (107_771_827_200, 17_174_860_800)
        assert j_count_params(jcfg) != total                    # the reference's int32 wrap
    else:
        assert active == total == j_count_params(jcfg)


def _moe_case(smoke, moe):
    """(reference cfg, port cfg, reference layer-0 MoE params, port MoE):
    the smoke model's converted layer-0 weights under the MoE sub-config
    with ``moe``'s fields (the shared expert dropped where it has none)."""
    jcfg, tcfg, jp, lm = smoke
    jm, tm = replace(jcfg.moe, **moe), replace(tcfg.moe, **moe)
    jmoe = jax.tree.map(lambda a: jnp.asarray(a[0]), jp["segments"][0]["moe"])
    src = lm.segments[0][0].moe
    port = tmoe.init_moe(None, tm, tcfg.d_model, torch.float32)
    with torch.no_grad():
        for name, p in port.named_parameters():
            p.copy_(src.get_parameter(name))
    if not tm.num_shared_experts:
        del jmoe["shared"]
    return jm, tm, jmoe, port


def _route_both(jm, tm, jmoe, port, x):
    t = x.shape[0] * x.shape[1]
    cap = j_capacity(t, jm)
    want = j_route_group(jnp.asarray(x.reshape(t, -1)), jmoe["router"], jm, cap)
    got = tmoe._route_group(torch.from_numpy(x.reshape(1, t, -1)), port.router, tm, cap)
    return dict(zip(ROUTE_NAMES, want)), dict(zip(ROUTE_NAMES, (g[0] for g in got)))


MOE_CASES = {
    "llama4_smoke": {},                                          # top-1, one shared expert
    "top2_no_shared": {"top_k": 2, "num_shared_experts": 0},
    "top1_drops": {"capacity_factor": 0.25},
    "top2_drops": {"top_k": 2, "num_shared_experts": 0, "capacity_factor": 0.3},
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_forward_matches_reference(case, smoke):
    jm, tm, jmoe, port = _moe_case(smoke, MOE_CASES[case])
    assert hasattr(port, "shared") == ("shared" in jmoe) == (tm.num_shared_experts > 0)
    x = np.random.default_rng(11).standard_normal((2, 40, smoke[1].d_model), dtype=np.float32)
    want, got = _route_both(jm, tm, jmoe, port, x)
    for name in EXACT:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    for name in ("logits", "probs", "gate_vals"):
        np.testing.assert_allclose(_np(got[name]), np.asarray(want[name]), rtol=MOE_TOL,
                                   atol=MOE_TOL, err_msg=name)
    dropped = 1.0 - float(np.asarray(want["keep"]).mean())
    assert (dropped > 0) == case.endswith("drops"), dropped

    jy, jaux = j_moe_forward(jmoe, jnp.asarray(x), cfg=jm)
    with torch.no_grad():
        ty, taux = tmoe.moe_forward(port, torch.from_numpy(x), cfg=tm)
    assert ty.dtype == torch.float32 and ty.shape == x.shape
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=MOE_TOL, atol=MOE_TOL)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=AUX_RTOL,
                                   atol=AUX_ATOL, err_msg=k)
    assert float(taux["moe_drop_frac"]) == pytest.approx(dropped)


@pytest.mark.parametrize("top_k", [1, 2])
def test_routing_ties_go_to_the_lowest_expert(top_k, smoke):
    """A zero router makes every probability equal: ``jax.lax.top_k`` takes
    the lowest experts, and so must the port."""
    jm, tm, jmoe, port = _moe_case(smoke, {"top_k": top_k})
    with torch.no_grad():
        port.router.zero_()
    jmoe["router"] = jnp.zeros_like(jmoe["router"])
    x = np.random.default_rng(12).standard_normal((1, 16, smoke[1].d_model), dtype=np.float32)
    want, got = _route_both(jm, tm, jmoe, port, x)
    assert (np.asarray(want["expert_idx"]) == np.arange(top_k)).all()
    for name in EXACT:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)


def test_conversion_keeps_expert_stacks_and_shared_expert(smoke):
    _, tcfg, jp, lm = smoke
    npp = jax.tree.map(np.asarray, jp)
    seg = npp["segments"][0]["moe"]
    e, f, d = tcfg.moe.num_experts, tcfg.moe.expert_d_ff, tcfg.d_model
    assert seg["w_gate"].shape == (tcfg.num_layers, e, d, f)
    for j, layer in enumerate(lm.segments[0]):
        m = layer.moe
        assert m.router.dtype == torch.float32
        for name in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(getattr(m, name).numpy(), seg[name][j], err_msg=name)
        for name in ("w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(getattr(m.shared, name).numpy(),
                                          seg["shared"][name][j], err_msg=name)
    bad = jax.tree.map(lambda a: a, npp)
    bad["segments"][0]["moe"]["w_up"] = seg["w_up"][:, :, :, :8]
    with pytest.raises(ValueError, match="w_up"):
        lm_params_from_reference(bad, tcfg, device="cpu")


def test_stack_init_draws_one_dense_projection():
    """``_stack_init`` is one (d_in, E * d_out) fan-in draw, reshaped and
    transposed (``repro/models/moe.py`` ``_stack_init``)."""
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    stacked = tmoe._stack_init(g1, 4, 16, 8, torch.float32, "cpu")
    dense = tlayers.dense_init(g2, 16, 32, torch.float32)
    assert stacked.shape == (4, 16, 8) and stacked.is_contiguous()
    torch.testing.assert_close(stacked, dense.reshape(16, 4, 8).permute(1, 0, 2), rtol=0,
                               atol=0)


# ---------------------------------------------------------------------------
# the slice: prefill, splice and greedy decode against the reference's flow
# ---------------------------------------------------------------------------


def reference_generate(jcfg, jp, toks, n_tokens):
    """The reference's serving loop (``repro/launch/serve.py``) on one
    device: prefill, its per-leaf splice, greedy decode. Returns (tokens,
    prefill's last logits)."""
    b, plen = toks.shape
    logits, pre = jax.jit(j_make_prefill_step(jcfg))(jp, {"tokens": jnp.asarray(toks)})

    def per_leaf(f, p):
        if f.shape == p.shape:
            return p.astype(f.dtype)
        axis = next(i for i, (a, c) in enumerate(zip(f.shape, p.shape)) if a != c)
        idx = [slice(None)] * f.ndim
        idx[axis] = slice(0, p.shape[axis])
        return f.at[tuple(idx)].set(p.astype(f.dtype))

    cache = jax.tree.map(per_leaf, j_init_cache(jcfg, b, plen + n_tokens), pre)
    serve = jax.jit(j_make_serve_step(jcfg))
    tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    outs = [tok]
    for i in range(n_tokens - 1):
        _, nxt, cache = serve(jp, cache, jnp.asarray(plen + i, jnp.int32), tok)
        tok = nxt[:, None]
        outs.append(tok)
    return np.asarray(jnp.concatenate(outs, axis=1)), np.asarray(logits)


def test_prefill_logits_and_aux_match_reference(smoke, monkeypatch):
    """lm_forward in prefill mode through the flash switch: one kernel
    dispatch per attention layer, the logits and the K/V cache against
    the reference's, and the aux losses summed over the layers."""
    jcfg, tcfg, jp, lm = smoke
    toks = prompts(2, 128, tcfg.vocab_size, seed=5)
    jl, jc, jaux = j_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg, mode="prefill")
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    with torch.no_grad():
        tl, tc, taux = t_forward(lm, {"tokens": torch.from_numpy(toks)}, tcfg, mode="prefill",
                               use_flash_kernel=True)
    assert len(calls) == tcfg.num_layers
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc["segments"][0]["kv"][name]),
                                   np.asarray(jc["segments"][0]["kv"][name]), atol=LOGIT_TOL)
    assert set(taux) == set(jaux) == {"moe_lb_loss", "moe_z_loss", "moe_drop_frac"}
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=AUX_RTOL,
                                   atol=AUX_ATOL, err_msg=k)


def test_greedy_tokens_equal_reference(smoke):
    """8 greedy tokens after a 128-token prompt through the launcher's
    generate (flash prefill, spliced cache, in-place decode) equal the
    reference's; the last prefill logits within 1e-4."""
    jcfg, tcfg, jp, lm = smoke
    toks = prompts(2, 128, tcfg.vocab_size, seed=7)
    want, want_logits = reference_generate(jcfg, jp, toks, 8)
    logits, _ = tserve.prefill(lm, tcfg, torch.from_numpy(toks), 136)
    np.testing.assert_allclose(_np(logits), want_logits, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    got, _ = tserve.generate(lm, tcfg, torch.from_numpy(toks), tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_launcher_smoke_on_cpu(capsys):
    out = tserve.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "128",
                       "--tokens", "4", "--device", "cpu"])
    assert tuple(out.shape) == (2, 4) and out.dtype == torch.int32
    assert "generated (2, 4)" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# bf16 weights under float32 activations (ROADMAP queue 3)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", ARCH])
def test_bf16_weights_f32_activations_match_reference(arch):
    """``param_dtype="bfloat16"`` with ``compute_dtype="float32"``: the
    reference's ``jnp`` promotes every mixed ``x @ W`` to float32, and so
    does the port's ``layers.matmul``: prefill logits within 1e-4."""
    over = dict(param_dtype="bfloat16", compute_dtype="float32")
    jcfg = replace(J_CONFIGS[arch].smoke(), **over)
    tcfg = replace(MODEL_CONFIGS[arch].smoke(), **over)
    jp = init_params(jax.random.key(1), jcfg)
    lm = lm_params_from_reference(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    assert lm.embed.dtype == torch.bfloat16
    toks = prompts(2, 128, tcfg.vocab_size, seed=8)
    jl, _, _ = j_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg, mode="prefill")
    with torch.no_grad():
        tl, _, _ = t_forward(lm, {"tokens": torch.from_numpy(toks)}, tcfg, mode="prefill",
                             use_flash_kernel=True)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_matmul_promotes_like_jnp():
    x = torch.randn(3, 8)
    w = torch.randn(8, 5).to(torch.bfloat16)
    got = tlayers.matmul(x, w)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, x @ w.float(), rtol=0, atol=0)
    assert tlayers.matmul(x.bfloat16(), w).dtype == torch.bfloat16
    xb = x.bfloat16()
    assert torch.equal(tlayers.matmul(xb, w), xb @ w)              # one type: as it was


# ---------------------------------------------------------------------------
# MoE through the ported training step
# ---------------------------------------------------------------------------

STEPS, BATCH, SEQ = 3, 4, 32


def test_moe_training_steps_match_reference():
    """Three AdamW steps of llama4's smoke model (microbatch 4, as the
    config sets) from the reference's initial state: the loss, the CE, the
    grad norm and the three MoE metrics against ``repro.train``'s."""
    jcfg, tcfg = J_CONFIGS[ARCH].smoke(), MODEL_CONFIGS[ARCH].smoke()
    assert tcfg.optimizer == "adamw" and tcfg.microbatch == 4
    corpus = zipf_corpus(np.random.default_rng(0), tcfg.vocab_size, 20_000)
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(STEPS):
        s = int(rng.integers(0, len(corpus) - BATCH * (SEQ + 1)))
        w = corpus[s:s + BATCH * (SEQ + 1)].reshape(BATCH, SEQ + 1)
        batches.append({"tokens": w[:, :-1].copy(), "labels": w[:, 1:].copy()})

    state = j_make_train_state(jax.random.key(0), jcfg)
    init = jax.tree.map(np.asarray, state)
    jstep = jax.jit(j_make_train_step(jcfg, lr_schedule=j_warmup_cosine(1e-3, 1, STEPS)))
    want = []
    for b in batches:
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        want.append({k: float(v) for k, v in m.items()})

    tstate = train_state_from_reference(init, tcfg, device="cpu")
    tstep = make_train_step(tcfg, lr_schedule=warmup_cosine(1e-3, 1, STEPS))
    got = []
    for b in batches:
        tstate, m = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        got.append({k: float(v) for k, v in m.items()})

    for i, (g, w) in enumerate(zip(got, want)):
        assert {"moe_lb_loss", "moe_z_loss", "moe_drop_frac"} <= set(w)
        assert set(g) == set(w), (sorted(g), sorted(w))
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=TRAIN_RTOL, atol=TRAIN_ATOL,
                                       err_msg=f"step {i} {k}")


def test_remat_carries_the_aux_out(smoke):
    """With remat on, each layer runs under ``torch.utils.checkpoint`` and
    its MoE losses come out with its output: the loss, the three MoE
    metrics and every gradient equal the unrematerialised run's."""
    from repro_torch.train import make_loss_fn

    _, tcfg, jp, _ = smoke
    toks = prompts(2, 32, tcfg.vocab_size, seed=13)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())}
    runs = []
    for remat in (False, True):
        cfg = replace(tcfg, remat=remat)
        lm = lm_params_from_reference(jax.tree.map(np.asarray, jp), cfg, device="cpu")
        lm.requires_grad_(True)
        loss, metrics = make_loss_fn(cfg)(lm, batch)
        grads = torch.autograd.grad(loss, list(lm.parameters()))
        runs.append((metrics, grads))
    (m0, g0), (m1, g1) = runs
    assert {"moe_lb_loss", "moe_z_loss", "moe_drop_frac"} <= set(m1)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
