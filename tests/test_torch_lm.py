"""The port's LM serving slice (tinyllama-1.1b) on the CPU, against the JAX
package on the same weights and inputs.

Weights cross over as numpy arrays: the reference draws them from its
key (``init_params(jax.random.key(0), cfg)``) and
``api.convert.lm_params_from_reference`` loads them into the port's
modules. Everything runs at tinyllama's ``smoke()`` size (2 layers,
d_model 256, 4 query heads on 1 KV head, head dim 64, vocab 512) in
float32, where the tolerances are the reference's own (atol 2e-5 for
attention outputs, 1e-4 for prefill/decode consistency) or stated below
from float32 summation order; greedy tokens must be equal. One bfloat16
case holds the port's bf16 prefill to the reference's at a measured
tolerance.
"""
import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MODEL_CONFIGS as J_CONFIGS
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models.attention import attention_forward as j_attention_forward
from repro.models.layers import apply_mlp as j_apply_mlp
from repro.models.layers import apply_norm as j_apply_norm
from repro.models.layers import apply_rope as j_apply_rope
from repro.models.params import count_params_analytic as j_count_params
from repro.models.params import forward as j_forward
from repro.train import make_prefill_step as j_make_prefill_step
from repro.train import make_serve_step as j_make_serve_step
from repro_torch.api import lm_params_from_reference
from repro_torch.configs import MODEL_CONFIGS, get_config
from repro_torch.configs.base import AttentionConfig, FrontendStub, HybridConfig
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import count_params_analytic, forward, init_cache, init_params, param_bytes
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.train import make_prefill_step, make_serve_step

torch.set_num_threads(2)
ARCH = "tinyllama-1.1b"
# float32 logits of the 2-layer model: products summed in another order
# than XLA's; measured max |difference| 2.4e-6 at |logits| up to 4.2
# (prompt seeds 0-4)
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    """(reference cfg, port cfg, reference params, port model, numpy tree)."""
    jcfg = J_CONFIGS[ARCH].smoke()
    tcfg = MODEL_CONFIGS[ARCH].smoke()
    jp = j_init_params(jax.random.key(0), jcfg)
    npp = jax.tree.map(np.asarray, jp)
    return jcfg, tcfg, jp, lm_params_from_reference(npp, tcfg, device="cpu"), npp


def prompts(batch, plen, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (batch, plen)).astype(np.int32)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def test_config_matches_reference():
    for full in (False, True):
        j = J_CONFIGS[ARCH] if full else J_CONFIGS[ARCH].smoke()
        t = get_config(ARCH) if full else get_config(ARCH).smoke()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.padded_vocab == j.padded_vocab and t.layer_kinds() == j.layer_kinds()
    assert MODEL_CONFIGS[ARCH].attention.resolved_head_dim(2048) == 64


def test_param_count_without_allocating():
    cfg = get_config(ARCH)
    assert count_params_analytic(cfg) == 1_100_048_384 == j_count_params(J_CONFIGS[ARCH])
    assert cfg.num_params() == 1_100_048_384
    assert param_bytes(cfg) == 2 * 1_100_048_384


def test_conversion_keeps_every_weight(models):
    _, _, _, lm, npp = models
    np.testing.assert_array_equal(lm.embed.numpy(), npp["embed"])
    np.testing.assert_array_equal(lm.lm_head.numpy(), npp["lm_head"])
    seg = npp["segments"][0]
    for j, layer in enumerate(lm.segments[0]):
        np.testing.assert_array_equal(layer.attn.wq.numpy(), seg["attn"]["wq"][j])
        np.testing.assert_array_equal(layer.mlp.w_down.numpy(), seg["mlp"]["w_down"][j])
        np.testing.assert_array_equal(layer.ln2.scale.numpy(), seg["ln2"]["scale"][j])
    bad = dict(npp, lm_head=npp["lm_head"][:, :8])
    with pytest.raises(ValueError, match="lm_head"):
        lm_params_from_reference(bad, models[1], device="cpu")


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_apply_norm(eps):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32) * 3
    scale = rng.standard_normal(64, dtype=np.float32)
    p = tlayers.init_norm(64, torch.float32)
    p.scale.data.copy_(torch.from_numpy(scale))
    got = tlayers.apply_norm(p, torch.from_numpy(x), eps=eps)
    want = j_apply_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x), kind="rmsnorm", eps=eps)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("option", ["layernorm", "gelu", "frontend", "hybrid"])
def test_unported_options_raise_at_build(option):
    """Config options no registered architecture uses raise when the model
    is built, not later in forward. (QKV bias, which this case list held
    until it was ported, is held against the reference in
    ``tests/test_torch_qkv_bias.py``.)"""
    cfg = MODEL_CONFIGS[ARCH].smoke()
    cfg = {
        "layernorm": lambda: replace(cfg, norm="layernorm"),
        "gelu": lambda: replace(cfg, act="gelu"),
        "frontend": lambda: replace(cfg, frontend=FrontendStub(kind="vision_patches",
                                                               tokens_per_item=16,
                                                               embed_dim=128)),
        "hybrid": lambda: replace(cfg, arch_type="hybrid", hybrid=HybridConfig(attn_every=2)),
    }[option]()
    with pytest.raises(NotImplementedError, match="not ported yet"):
        init_params(torch.Generator(), cfg, device="cpu")


@pytest.mark.parametrize("heads", [False, True])
def test_apply_rope_is_the_half_split_rotation(heads):
    rng = np.random.default_rng(2)
    shape = (2, 7, 3, 64) if heads else (2, 7, 64)
    x = rng.standard_normal(shape, dtype=np.float32)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    want = j_apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    # cos/sin of angles up to 4000 rad, rounded by two libraries
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)


def test_apply_mlp(models):
    _, tcfg, _, lm, npp = models
    x = np.random.default_rng(3).standard_normal((2, 9, tcfg.d_model), dtype=np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a[1]), npp["segments"][0]["mlp"])
    want = j_apply_mlp(jp, jnp.asarray(x), act="silu")
    got = tlayers.apply_mlp(lm.segments[0][1].mlp, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("flash", [False, True])
def test_attention_forward_prefill_and_decode(models, flash):
    """Layer 0's attention: prefill over 128 tokens (with and without the
    flash switch), then one decode step into a 136-slot cache."""
    jcfg, tcfg, _, lm, npp = models
    b, s, d = 2, 128, tcfg.d_model
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, s + 1, d), dtype=np.float32)
    pos = np.broadcast_to(np.arange(s + 1, dtype=np.int32)[None], (b, s + 1))
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), npp["segments"][0]["attn"])
    p = lm.segments[0][0].attn
    kw = dict(d_model=d)
    jy, jc = j_attention_forward(jp, jnp.asarray(x[:, :s]), cfg=jcfg.attention,
                                 positions=jnp.asarray(pos[:, :s]), mode="prefill", **kw)
    ty, tc = tattn.attention_forward(p, torch.from_numpy(x[:, :s]), cfg=tcfg.attention,
                                     positions=torch.from_numpy(np.ascontiguousarray(pos[:, :s])),
                                     mode="prefill", use_flash_kernel=flash, **kw)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=2e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name]), atol=2e-5)

    pad = ((0, 0), (0, 8), (0, 0), (0, 0))
    jcache = {n: jnp.pad(a, pad) for n, a in jc.items()}
    tcache = {n: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 8)) for n, a in tc.items()}
    jy, jc2 = j_attention_forward(jp, jnp.asarray(x[:, s:]), cfg=jcfg.attention,
                                  positions=jnp.asarray(pos[:, s:]), mode="decode",
                                  cache=jcache, cache_index=jnp.asarray(s, jnp.int32), **kw)
    ty, tc2 = tattn.attention_forward(p, torch.from_numpy(x[:, s:]), cfg=tcfg.attention,
                                      positions=torch.from_numpy(np.ascontiguousarray(pos[:, s:])),
                                      mode="decode", cache=tcache, cache_index=s, **kw)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=2e-5)
    for name in ("k", "v"):
        assert tc2[name] is tcache[name]                  # written in place
        np.testing.assert_allclose(_np(tc2[name]), np.asarray(jc2[name]), atol=2e-5)


def test_gqa_prefill_decode_consistency():
    """Prefill on s tokens, then decode token s: must match a full forward
    over s + 1 tokens at the last position (``tests/test_models.py``)."""
    cfg = AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16)
    d_model = 64
    gen = torch.Generator().manual_seed(2)
    p = tattn.init_attention(gen, cfg, d_model, torch.float32)
    b, s = 2, 12
    x = torch.randn(b, s + 1, d_model, generator=gen)
    pos = torch.arange(s + 1, dtype=torch.int32)[None].expand(b, s + 1)
    y_full, _ = tattn.attention_forward(p, x, cfg=cfg, d_model=d_model, positions=pos)
    _, cache = tattn.attention_forward(p, x[:, :s], cfg=cfg, d_model=d_model,
                                       positions=pos[:, :s], mode="prefill")
    cache = {n: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 1)) for n, a in cache.items()}
    y_dec, _ = tattn.attention_forward(p, x[:, s:], cfg=cfg, d_model=d_model,
                                       positions=pos[:, s:], mode="decode", cache=cache,
                                       cache_index=s)
    np.testing.assert_allclose(_np(y_dec[:, 0]), _np(y_full[:, s]), atol=1e-4)


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_logits_match_reference(models, flash, monkeypatch):
    """lm_forward in prefill mode: logits and cache against the reference's
    prefill; with the switch on, every layer's attention goes through
    ops.flash_attention (once per layer)."""
    jcfg, tcfg, jp, lm, _ = models
    toks = prompts(2, 128, tcfg.vocab_size, seed=5)
    jl, jc, _ = j_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg, mode="prefill")
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    with torch.no_grad():
        tl, tc, _ = forward(lm, {"tokens": torch.from_numpy(toks)}, tcfg, mode="prefill",
                            use_flash_kernel=flash)
    assert len(calls) == (tcfg.num_layers if flash else 0)
    assert tl.shape == (2, 128, tcfg.padded_vocab)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc["segments"][0]["kv"][name]),
                                   np.asarray(jc["segments"][0]["kv"][name]), atol=1e-4)


def _j_splice(full, pre):
    def leaf(f, p):
        return f.at[:, :, :p.shape[2]].set(p.astype(f.dtype))
    return jax.tree.map(leaf, full, pre)


def reference_generate(jcfg, jp, toks, n_tokens):
    """The reference's serving loop (``repro/launch/serve.py``) on one
    device: prefill, splice, greedy decode. Returns (tokens, first
    decode step's logits)."""
    b, plen = toks.shape
    logits, pre = jax.jit(j_make_prefill_step(jcfg))(jp, {"tokens": jnp.asarray(toks)})
    cache = _j_splice(j_init_cache(jcfg, b, plen + n_tokens), pre)
    serve = jax.jit(j_make_serve_step(jcfg))
    tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    outs, first = [tok], None
    for i in range(n_tokens - 1):
        lg, nxt, cache = serve(jp, cache, jnp.asarray(plen + i, jnp.int32), tok)
        first = lg if first is None else first
        tok = nxt[:, None]
        outs.append(tok)
    return np.asarray(jnp.concatenate(outs, axis=1)), np.asarray(first)


def test_serve_step_next_tokens(models):
    jcfg, tcfg, jp, lm, _ = models
    toks = prompts(2, 128, tcfg.vocab_size, seed=6)
    want, want_logits = reference_generate(jcfg, jp, toks, 2)
    logits, cache = tserve.prefill(lm, tcfg, torch.from_numpy(toks), 130)
    tok = tserve.greedy(logits)
    lg, nxt, cache2 = make_serve_step(tcfg)(lm, cache, 128, tok)
    assert cache2["segments"][0]["kv"]["k"] is cache["segments"][0]["kv"]["k"]   # in place
    assert nxt.dtype == torch.int32
    np.testing.assert_allclose(_np(lg), want_logits, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_array_equal(torch.cat([tok, nxt[:, None]], 1).numpy(), want)


def test_greedy_tokens_equal_reference(models, monkeypatch):
    """8 greedy tokens after a 128-token prompt, through the launcher's
    generate (flash prefill, in-place cache): equal to the reference's
    loop. The kernel dispatch is reached once per layer in prefill and
    never in decode."""
    jcfg, tcfg, jp, lm, _ = models
    toks = prompts(2, 128, tcfg.vocab_size, seed=7)
    want, _ = reference_generate(jcfg, jp, toks, 8)
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got, stats = tserve.generate(lm, tcfg, torch.from_numpy(toks), tokens=8)
    assert len(calls) == tcfg.num_layers
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats["prefill_ms"] > 0 and stats["decode_ms_per_token"] > 0


# bfloat16 weights and activations: XLA-CPU and torch-CPU round bf16
# products and silu at other places, so the logits differ by one or two
# bf16 ulps (0.016 at |logit| 2-4). Measured max |difference| 0.023-0.031
# over prompt seeds 0-4, with and without the flash switch (logits' std
# 0.53); held at 0.1.
BF16_LOGIT_TOL = 0.1


def test_bfloat16_prefill_logits(models):
    _, _, _, _, npp = models
    jcfg = replace(J_CONFIGS[ARCH].smoke(), param_dtype="bfloat16", compute_dtype="bfloat16")
    tcfg = replace(MODEL_CONFIGS[ARCH].smoke(), param_dtype="bfloat16",
                   compute_dtype="bfloat16")
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), npp)
    lm = lm_params_from_reference(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    assert lm.embed.dtype == torch.bfloat16
    toks = prompts(2, 128, tcfg.vocab_size, seed=8)
    jl, _, _ = j_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg, mode="prefill")
    with torch.no_grad():
        tl, _, _ = forward(lm, {"tokens": torch.from_numpy(toks)}, tcfg, mode="prefill",
                           use_flash_kernel=True)
    assert tl.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tl), np.asarray(jl, np.float32), atol=BF16_LOGIT_TOL)


def test_launcher_smoke_on_cpu(capsys):
    out = tserve.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "128",
                       "--tokens", "4", "--device", "cpu"])
    assert tuple(out.shape) == (2, 4) and out.dtype == torch.int32
    assert int(out.min()) >= 0 and int(out.max()) < MODEL_CONFIGS[ARCH].smoke().padded_vocab
    assert "generated (2, 4)" in capsys.readouterr().out


@pytest.mark.parametrize("entry", ["init_params", "init_cache", "convert", "serve"])
def test_lm_entry_points_raise_without_a_card(entry, models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    cfg = MODEL_CONFIGS[ARCH].smoke()
    call = {
        "init_params": lambda: init_params(torch.Generator(), cfg),
        "init_cache": lambda: init_cache(cfg, 1, 8),
        "convert": lambda: lm_params_from_reference(models[4], cfg),
        "serve": lambda: tserve.main(["--arch", ARCH, "--smoke"]),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
