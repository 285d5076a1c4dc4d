"""Multi-head latent attention (MLA), its absorbed decode, and the
multi-token prediction (MTP) head: deepseek-v3-671b on the CPU, against
the JAX package on the same weights and inputs.

Weights cross over as numpy arrays (``api.convert.lm_params_from_reference``:
the MLA leaves, the stacked dense and MoE segments and the MTP head's
one-layer stack); inputs are drawn from a numpy seed and fed to both
packages. Everything runs at deepseek's ``smoke()`` size in float32: 2
layers (1 dense, 1 MoE), d_model 256, 4 heads, q_lora 64, kv_lora 32,
rope 16, nope 32, v 32, 4 experts top-2 plus 1 shared, one MTP layer.
Tolerances: the MLA layer (prefill, absorbed decode, the latent and rope
caches) atol = rtol = 1e-5 (float32 sums in another order than XLA's); a
decode after a prefill against the longer prefill 1e-4
(``tests/test_models.py``'s consistency bound); logits and ``mtp_logits``
at ``tests/test_torch_lm.py``'s 1e-4, the MoE aux losses at
``tests/test_torch_moe.py``'s; three Adafactor steps (the config's
optimizer and microbatch 16) at ``tests/test_torch_train.py``'s rtol
1e-4 / atol 1e-5. Denormals are flushed, as XLA's CPU backend flushes
them.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MODEL_CONFIGS as J_CONFIGS
from repro.models import init_cache as j_init_cache
from repro.models import init_params
from repro.models.attention import attention_forward as j_attention_forward
from repro.models.params import count_params_analytic as j_count_params
from repro.models.params import forward
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.train import make_loss_fn as j_make_loss_fn
from repro.train import make_prefill_step as j_make_prefill_step
from repro.train import make_serve_step as j_make_serve_step
from repro.train import make_train_state as j_make_train_state
from repro.train import make_train_step as j_make_train_step
from repro.train import train_state_shapes as j_train_state_shapes
from repro_torch.api import lm_params_from_reference
from repro_torch.api.convert import (reference_tree, train_state_from_reference,
                                     train_state_to_reference)
from repro_torch.checkpoint.checkpointer import _flatten
from repro_torch.configs import MODEL_CONFIGS, get_config
from repro_torch.data.lm_data import zipf_corpus
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import count_params_analytic, init_cache, param_bytes
from repro_torch.models import attention as tattn
from repro_torch.models import forward as t_forward
from repro_torch.optim import warmup_cosine
from repro_torch.train import make_loss_fn, make_train_step, train_state_shapes

j_forward = jax.jit(forward, static_argnums=(2,), static_argnames=("mode",))

torch.set_num_threads(2)
ARCH = "deepseek-v3-671b"
TOL = 1e-5
DECODE_TOL = 1e-4
LOGIT_TOL = 1e-4
AUX_RTOL, AUX_ATOL = 1e-6, 2.0 ** -23
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-5
STEPS, BATCH, SEQ = 3, 16, 32


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


@pytest.fixture(scope="module")
def smoke():
    """(reference cfg, port cfg, reference params, port LM)."""
    jcfg, tcfg = J_CONFIGS[ARCH].smoke(), MODEL_CONFIGS[ARCH].smoke()
    jp = init_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jp, lm_params_from_reference(jax.tree.map(np.asarray, jp), tcfg,
                                                    device="cpu")


def prompts(batch, plen, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (batch, plen)).astype(np.int32)


def _positions(b, s):
    return np.tile(np.arange(s, dtype=np.int32)[None], (b, 1))


# ---------------------------------------------------------------------------
# the config, the weights and the counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_config_matches_reference(full):
    j = J_CONFIGS[ARCH] if full else J_CONFIGS[ARCH].smoke()
    t = get_config(ARCH) if full else get_config(ARCH).smoke()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.padded_vocab == j.padded_vocab and t.layer_kinds() == j.layer_kinds()
    att = t.attention
    if full:
        assert (t.d_model, att.num_heads, att.q_lora_rank, att.kv_lora_rank) == (7168, 128,
                                                                                  1536, 512)
        assert t.layer_kinds()[:4] == ("attn", "attn", "attn", "moe") and t.mtp_depth == 1
    else:
        assert (t.num_layers, t.d_model, att.num_heads, att.q_lora_rank, att.kv_lora_rank,
                att.qk_rope_head_dim, att.qk_nope_head_dim, att.v_head_dim) == (
                    2, 256, 4, 64, 32, 16, 32, 32)
        assert t.layer_kinds() == ("attn", "moe") and t.mtp_depth == 1


def test_conversion_maps_the_mla_and_mtp_leaves(smoke):
    jcfg, tcfg, jp, lm = smoke
    npp = jax.tree.map(np.asarray, jp)
    names = ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo")
    for i, seg in enumerate(npp["segments"]):
        for j, layer in enumerate(lm.segments[i]):
            assert isinstance(layer.attn, tattn.MLA)
            for name in names:
                np.testing.assert_array_equal(getattr(layer.attn, name).numpy(),
                                              seg["attn"][name][j], err_msg=name)
            for norm in ("q_norm", "kv_norm"):
                np.testing.assert_array_equal(getattr(layer.attn, norm).scale.numpy(),
                                              seg["attn"][norm]["scale"][j])
    mtp = npp["mtp"]
    assert mtp["proj"].shape == (2 * tcfg.d_model, tcfg.d_model)
    np.testing.assert_array_equal(lm.mtp.proj.numpy(), mtp["proj"])
    assert mtp["layer"]["moe"]["w_gate"].shape[0] == 1
    np.testing.assert_array_equal(lm.mtp.layer.moe.w_gate.numpy(), mtp["layer"]["moe"]["w_gate"][0])
    np.testing.assert_array_equal(lm.mtp.layer.attn.wkv_b.numpy(), mtp["layer"]["attn"]["wkv_b"][0])
    bad = jax.tree.map(lambda a: a, npp)
    bad["mtp"]["proj"] = mtp["proj"][:, :8]
    with pytest.raises(ValueError, match="mtp.proj"):
        lm_params_from_reference(bad, tcfg, device="cpu")
    del bad["mtp"]
    with pytest.raises(KeyError):
        lm_params_from_reference(bad, tcfg, device="cpu")


@functools.lru_cache(maxsize=2)
def _reference_shapes(jcfg):
    shapes = jax.eval_shape(lambda k: init_params(k, jcfg), jax.random.key(0))
    return [(jax.tree_util.keystr(path), leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]]


def _reference_counts(jcfg, wrap: bool):
    """(total, active) from the reference's own leaf shapes and its
    weighting rule (``repro/models/params.py``), the leaf sizes as Python
    integers, or wrapped to int32 as its ``jnp.prod`` computes them."""
    frac = jcfg.moe.top_k / jcfg.moe.num_experts
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


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_param_counts_match_reference(full):
    """Total and active counts, MLA and the MTP head included, built on the
    meta device, against the reference's leaf shapes under its weighting
    rule. At full size the reference's ``count_params_analytic`` takes
    each leaf's size as an int32 ``jnp.prod``, which wraps on the stacked
    (58, 256, 7168, 2048) expert leaves: its number is exactly the wrapped
    sum, and the port's equals it modulo 2^32."""
    cfg, jcfg = (get_config(ARCH), J_CONFIGS[ARCH]) if full else (
        get_config(ARCH).smoke(), J_CONFIGS[ARCH].smoke())
    total = count_params_analytic(cfg)
    active = count_params_analytic(cfg, active_only=True)
    assert (total, active) == _reference_counts(jcfg, wrap=False)
    assert total == cfg.num_params() and active == cfg.num_active_params()
    assert param_bytes(cfg) == (2 if full else 4) * total
    j_total, j_active = j_count_params(jcfg), j_count_params(jcfg, active_only=True)
    assert (j_total, j_active) == _reference_counts(jcfg, wrap=True)
    assert (total - j_total) % 2 ** 32 == 0
    if full:
        assert j_total != total                                  # the reference's int32 wrap
        assert total == 682_636_450_816
    else:
        assert (j_total, j_active) == (total, active)


def test_train_state_shapes_are_the_references_once_stacked():
    """The Adafactor state of the smoke model, the MTP head's one-layer
    stacks included, has the reference's leaves."""
    for tcfg, jcfg in ((MODEL_CONFIGS[ARCH].smoke(), J_CONFIGS[ARCH].smoke()),):
        shapes = train_state_shapes(tcfg)
        got = [(p, tuple(t.shape), str(t.dtype).removeprefix("torch."))
               for p, t in _flatten(reference_tree(shapes))]
        want = [(jax.tree_util.keystr(p), tuple(s.shape), str(s.dtype))
                for p, s in jax.tree_util.tree_flatten_with_path(j_train_state_shapes(jcfg))[0]]
        assert got == want
        assert any(p.startswith("['params']['mtp']['layer']") for p, _, _ in got)


# ---------------------------------------------------------------------------
# the MLA layer
# ---------------------------------------------------------------------------


def _mla_case(smoke, layer=0):
    jcfg, tcfg, jp, lm = smoke
    jpa = jax.tree.map(lambda a: a[0], jp["segments"][layer]["attn"])
    return jcfg, tcfg, jpa, lm.segments[layer][0].attn


def test_mla_prefill_and_absorbed_decode_match_reference(smoke):
    """Layer 0's MLA: prefill over 128 tokens (its latent and rope caches),
    then one absorbed decode step into a 136-slot cache, against the
    reference's ``_mla_forward``."""
    jcfg, tcfg, jpa, p = _mla_case(smoke)
    b, s, d = 2, 128, tcfg.d_model
    x = np.random.default_rng(4).standard_normal((b, s + 1, d), dtype=np.float32)
    pos = _positions(b, s + 1)
    jy, jc = j_attention_forward(jpa, jnp.asarray(x[:, :s]), cfg=jcfg.attention, d_model=d,
                                 positions=jnp.asarray(pos[:, :s]), mode="prefill")
    with torch.no_grad():
        ty, tc = tattn.attention_forward(p, torch.from_numpy(x[:, :s]), cfg=tcfg.attention,
                                         d_model=d, positions=torch.from_numpy(pos[:, :s]),
                                         mode="prefill", use_flash_kernel=True)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=TOL, rtol=TOL)
    assert set(tc) == {"latent", "k_rope"}
    assert tc["latent"].shape == (b, s, 32) and tc["k_rope"].shape == (b, s, 16)
    for name in ("latent", "k_rope"):
        np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name]), atol=TOL, rtol=TOL)

    empty = tattn.init_kv_cache(tcfg.attention, d, b, s + 8, torch.float32)
    assert {n: tuple(a.shape) for n, a in empty.items()} == {
        n: a.shape for n, a in j_init_cache(jcfg, b, s + 8)["segments"][0]["kv"].items()
        for a in [a[0]]}
    pad = ((0, 0), (0, 8), (0, 0))
    jcache = {n: jnp.pad(a, pad) for n, a in jc.items()}
    tcache = {n: torch.nn.functional.pad(a, (0, 0, 0, 8)) for n, a in tc.items()}
    jy, jc2 = j_attention_forward(jpa, jnp.asarray(x[:, s:]), cfg=jcfg.attention, d_model=d,
                                  positions=jnp.asarray(pos[:, s:]), mode="decode",
                                  cache=jcache, cache_index=jnp.asarray(s, jnp.int32))
    with torch.no_grad():
        ty, tc2 = tattn.attention_forward(p, torch.from_numpy(x[:, s:]), cfg=tcfg.attention,
                                          d_model=d, positions=torch.from_numpy(pos[:, s:]),
                                          mode="decode", cache=tcache, cache_index=s)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=TOL, rtol=TOL)
    for name in ("latent", "k_rope"):
        assert tc2[name] is tcache[name]                  # written in place
        np.testing.assert_allclose(_np(tc2[name]), np.asarray(jc2[name]), atol=TOL, rtol=TOL)
        assert not tc2[name][:, s + 1:].any()             # the unwritten slots stay zero


def test_mla_train_mode_matches_reference(smoke):
    """Train mode over 64 tokens (one query chunk): the same output as the
    reference, and no cache."""
    jcfg, tcfg, jpa, p = _mla_case(smoke, layer=1)
    x = np.random.default_rng(6).standard_normal((2, 64, tcfg.d_model), dtype=np.float32)
    pos = _positions(2, 64)
    jy, _ = j_attention_forward(jpa, jnp.asarray(x), cfg=jcfg.attention, d_model=tcfg.d_model,
                                positions=jnp.asarray(pos), mode="train")
    with torch.no_grad():
        ty, tc = tattn.attention_forward(p, torch.from_numpy(x), cfg=tcfg.attention,
                                         d_model=tcfg.d_model, positions=torch.from_numpy(pos))
    assert tc is None
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=TOL, rtol=TOL)


def test_mla_decode_after_prefill_matches_the_longer_prefill(smoke):
    """A prefill of s tokens, then the absorbed decode of token s, against a
    prefill of s + 1 tokens at the last position; also a decode further
    into the cache (slots written one by one)."""
    _, tcfg, _, p = _mla_case(smoke)
    b, s, d = 2, 40, tcfg.d_model
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((b, s + 3, d),
                                                                  dtype=np.float32))
    pos = torch.from_numpy(_positions(b, s + 3))
    kw = dict(cfg=tcfg.attention, d_model=d)
    with torch.no_grad():
        full, _ = tattn.attention_forward(p, x, positions=pos, mode="prefill", **kw)
        _, cache = tattn.attention_forward(p, x[:, :s], positions=pos[:, :s], mode="prefill",
                                           **kw)
        cache = {n: torch.nn.functional.pad(a, (0, 0, 0, 3)) for n, a in cache.items()}
        for i in range(s, s + 3):
            y, cache = tattn.attention_forward(p, x[:, i:i + 1], positions=pos[:, i:i + 1],
                                               mode="decode", cache=cache, cache_index=i, **kw)
            np.testing.assert_allclose(_np(y[:, 0]), _np(full[:, i]), atol=DECODE_TOL,
                                       err_msg=f"position {i}")


def test_mla_decode_reads_nothing_back(smoke):
    """The absorbed decode takes ``cache_index`` as a Python int and reads
    no tensor back: under a guard that refuses ``.item()`` / ``.tolist()``
    and numpy conversions it runs through."""
    from repro_torch.analysis.sanitize import transfer_sanitizer

    _, tcfg, _, p = _mla_case(smoke)
    x = torch.randn(2, 1, tcfg.d_model, generator=torch.Generator().manual_seed(3))
    cache = tattn.init_kv_cache(tcfg.attention, tcfg.d_model, 2, 8, torch.float32)
    with torch.no_grad(), transfer_sanitizer(max_fetches=0):
        tattn.attention_forward(p, x, cfg=tcfg.attention, d_model=tcfg.d_model,
                                positions=torch.full((2, 1), 3, dtype=torch.int32),
                                mode="decode", cache=cache, cache_index=3)


# ---------------------------------------------------------------------------
# the model: prefill, decode, generation
# ---------------------------------------------------------------------------


def test_prefill_logits_caches_and_aux_match_reference(smoke, monkeypatch):
    """lm_forward in prefill mode with the flash switch on: MLA never
    reaches the kernel (its q and v heads differ in width), the logits,
    the stacked latent and rope caches of both segments and the MoE aux
    losses against the reference's."""
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
    assert calls == []
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for i in range(2):
        for name, width in (("latent", 32), ("k_rope", 16)):
            got = tc["segments"][i]["kv"][name]
            assert got.shape == (1, 2, 128, width)
            np.testing.assert_allclose(_np(got), np.asarray(jc["segments"][i]["kv"][name]),
                                       atol=TOL, rtol=TOL)
    assert "mtp_logits" not in taux and "mtp_logits" not in jaux
    assert set(taux) == set(jaux) == {"moe_lb_loss", "moe_z_loss", "moe_drop_frac"}
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=AUX_RTOL,
                                   atol=AUX_ATOL, err_msg=k)


def reference_generate(jcfg, jp, toks, n_tokens):
    """The reference's serving loop (``repro/launch/serve.py``): prefill,
    its per-leaf splice, greedy decode. Returns (tokens, prefill's last
    logits, the first decode step's logits)."""
    b, plen = toks.shape
    logits, pre = jax.jit(j_make_prefill_step(jcfg))(jp, {"tokens": jnp.asarray(toks)})

    def per_leaf(f, p):
        return f.at[:, :, :p.shape[2]].set(p.astype(f.dtype))

    cache = jax.tree.map(per_leaf, j_init_cache(jcfg, b, plen + n_tokens), pre)
    serve = jax.jit(j_make_serve_step(jcfg))
    tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    outs, first = [tok], None
    for i in range(n_tokens - 1):
        step_logits, nxt, cache = serve(jp, cache, jnp.asarray(plen + i, jnp.int32), tok)
        first = np.asarray(step_logits) if first is None else first
        tok = nxt[:, None]
        outs.append(tok)
    return np.asarray(jnp.concatenate(outs, axis=1)), np.asarray(logits), first


def test_greedy_tokens_and_decode_logits_equal_reference(smoke):
    """8 greedy tokens after a 128-token prompt through the launcher's
    generate (prefill, the latent and rope caches spliced, absorbed decode
    in place) equal the reference's; the last prefill logits and the first
    decode step's within 1e-4."""
    jcfg, tcfg, jp, lm = smoke
    toks = prompts(2, 128, tcfg.vocab_size, seed=7)
    want, want_logits, want_step = reference_generate(jcfg, jp, toks, 8)
    logits, cache = tserve.prefill(lm, tcfg, torch.from_numpy(toks), 136)
    np.testing.assert_allclose(_np(logits), want_logits, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert cache["segments"][1]["kv"]["latent"].shape == (1, 2, 136, 32)
    with torch.no_grad():
        step, _, _ = t_forward(lm, {"tokens": tserve.greedy(logits)}, tcfg, mode="decode",
                               cache=cache, cache_index=128)
    np.testing.assert_allclose(_np(step), want_step, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    got, _ = tserve.generate(lm, tcfg, torch.from_numpy(toks), tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_model_decode_after_prefill_matches_the_longer_prefill(smoke):
    """The whole smoke model: a prefill of 128 tokens spliced into a cache,
    then one absorbed decode step, against a prefill of the 129 tokens at
    the last position (the check the card makes in ``chip_smoke.py``)."""
    _, tcfg, _, lm = smoke
    toks = torch.from_numpy(prompts(2, 129, tcfg.vocab_size, seed=11))
    with torch.no_grad():
        full, _, _ = t_forward(lm, {"tokens": toks}, tcfg, mode="prefill")
        _, cache = tserve.prefill(lm, tcfg, toks[:, :128], 129)
        dec, _, _ = t_forward(lm, {"tokens": toks[:, 128:]}, tcfg, mode="decode", cache=cache,
                              cache_index=128)
    np.testing.assert_allclose(_np(dec[:, 0]), _np(full[:, 128]), atol=DECODE_TOL)
    assert init_cache(tcfg, 2, 129, device="cpu")["segments"][0]["kv"]["k_rope"].shape == (
        1, 2, 129, 16)


# ---------------------------------------------------------------------------
# MTP and training
# ---------------------------------------------------------------------------


def _batches(vocab, n=STEPS):
    corpus = zipf_corpus(np.random.default_rng(0), vocab, 20_000)
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n):
        s = int(rng.integers(0, len(corpus) - BATCH * (SEQ + 1)))
        w = corpus[s:s + BATCH * (SEQ + 1)].reshape(BATCH, SEQ + 1)
        out.append({"tokens": w[:, :-1].copy(), "labels": w[:, 1:].copy()})
    return out


def test_mtp_logits_and_loss_match_reference(smoke):
    """Train mode: ``aux["mtp_logits"]`` (the MTP head's prediction of token
    t + 2) against the reference's, and ``make_loss_fn``'s loss, CE,
    ``mtp_ce`` and MoE terms; prefill and S = 1 add no MTP logits."""
    jcfg, tcfg, jp, lm = smoke
    b = _batches(tcfg.vocab_size, 1)[0]
    jl, _, jaux = j_forward(jp, {"tokens": jnp.asarray(b["tokens"])}, jcfg, mode="train")
    with torch.no_grad():
        tl, tc, taux = t_forward(lm, {"tokens": torch.from_numpy(b["tokens"])}, tcfg,
                                 mode="train")
        _, _, one = t_forward(lm, {"tokens": torch.from_numpy(b["tokens"][:, :1])}, tcfg,
                              mode="train")
    assert tc is None and "mtp_logits" not in one
    assert taux["mtp_logits"].shape == (BATCH, SEQ, tcfg.padded_vocab)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_allclose(_np(taux["mtp_logits"]), np.asarray(jaux["mtp_logits"]),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    jloss, jm = jax.jit(j_make_loss_fn(jcfg))(jp, {k: jnp.asarray(v) for k, v in b.items()})
    with torch.no_grad():
        tloss, tm = make_loss_fn(tcfg)(lm, {k: torch.from_numpy(v) for k, v in b.items()})
    assert set(tm) == set(jm) and "mtp_ce" in tm
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TRAIN_RTOL,
                                   atol=TRAIN_ATOL, err_msg=k)
    np.testing.assert_allclose(float(tm["loss"]), float(
        tm["ce"] + tm["moe_lb_loss"] + tm["moe_z_loss"] + 0.3 * tm["mtp_ce"]), rtol=1e-6)


def _assert_trees_close(got, want, what, rtol=TRAIN_RTOL, atol=TRAIN_ATOL):
    g, w = _flatten(got), _flatten(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, c) in zip(g, w):
        np.testing.assert_allclose(_np(a), _np(c), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {path}")


def test_three_training_steps_match_reference():
    """Three steps of deepseek's smoke model with its own optimizer
    (Adafactor) and microbatch (16) from the reference's initial state:
    every metric (``mtp_ce`` and the MoE terms included) and the final
    weights and accumulators, the MTP head's among them."""
    jcfg, tcfg = J_CONFIGS[ARCH].smoke(), MODEL_CONFIGS[ARCH].smoke()
    assert tcfg.optimizer == "adafactor" and tcfg.microbatch == BATCH
    batches = _batches(tcfg.vocab_size)
    state = j_make_train_state(jax.random.key(0), jcfg)
    init = jax.tree.map(np.asarray, state)
    jstep = jax.jit(j_make_train_step(jcfg, lr_schedule=j_warmup_cosine(1e-3, 1, STEPS)))
    want = []
    for b in batches:
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        want.append({k: float(v) for k, v in m.items()})
    jfinal = jax.tree.map(np.asarray, state)

    tstate = train_state_from_reference(init, tcfg, device="cpu")
    tstep = make_train_step(tcfg, lr_schedule=warmup_cosine(1e-3, 1, STEPS))
    got = []
    for b in batches:
        tstate, m = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        got.append({k: float(v) for k, v in m.items()})
    for i, (g, w) in enumerate(zip(got, want)):
        assert {"mtp_ce", "moe_lb_loss", "moe_z_loss", "moe_drop_frac"} <= set(w)
        assert set(g) == set(w), (sorted(g), sorted(w))
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=TRAIN_RTOL, atol=TRAIN_ATOL,
                                       err_msg=f"step {i} {k}")
    _assert_trees_close(train_state_to_reference(tstate), jfinal, "after 3 steps")


@pytest.mark.parametrize("optimizer", ["adafactor", "adamw"])
def test_train_state_round_trip_carries_the_mtp_head(optimizer):
    """reference -> port -> reference is the identity, the ``mtp`` subtree
    (its (1, ...) layer leaves and their optimizer state) included; a
    missing ``mtp`` leaf raises."""
    jcfg = dataclasses.replace(J_CONFIGS[ARCH].smoke(), optimizer=optimizer)
    tcfg = dataclasses.replace(MODEL_CONFIGS[ARCH].smoke(), optimizer=optimizer)
    ref = jax.tree.map(np.asarray, j_make_train_state(jax.random.key(1), jcfg))
    state = train_state_from_reference(ref, tcfg, device="cpu")
    np.testing.assert_array_equal(state["params"].mtp.proj.detach().numpy(),
                                  ref["params"]["mtp"]["proj"])
    back = train_state_to_reference(state)
    assert back["params"]["mtp"]["layer"]["ln1"]["scale"].shape == (1, tcfg.d_model)
    _assert_trees_close(back, ref, optimizer, rtol=0, atol=0)
    del ref["params"]["mtp"]["proj"]
    with pytest.raises(ValueError, match="reference keys"):
        train_state_from_reference(ref, tcfg, device="cpu")


def test_launcher_smoke_on_cpu(capsys):
    out = tserve.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "128",
                       "--tokens", "4", "--device", "cpu"])
    assert tuple(out.shape) == (2, 4) and out.dtype == torch.int32
    assert "generated (2, 4)" in capsys.readouterr().out
