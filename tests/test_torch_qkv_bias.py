"""QKV bias and the three dense configs that carry it or run new GQA groups
(qwen2.5-3b, qwen1.5-4b, internlm2-1.8b) on the CPU, against the JAX
package on the same weights and inputs.

The reference initialises ``bq``, ``bk`` and ``bv`` to zeros, which would
hide a missing bias add, so every bias here is drawn from a numpy seed
into the reference's tree and carried into the port by
``api.convert.lm_params_from_reference``; both packages then run the same
numpy prompts. Everything runs at each config's ``smoke()`` size in
float32 (qwen2.5: 4 query heads on 1 KV head, qwen1.5: 4 on 4,
internlm2: 4 on 2, head dim 64). Tolerances: atol = rtol = 1e-5 for the
attention layer and the K/V caches (float32 sums in another order than
XLA's); the logits at ``tests/test_torch_lm.py``'s 1e-4 (the tied
embeddings' logits reach |20|, where float32 sums of 256 products in
another order differ by up to 2.2e-5); greedy tokens equal; the
bf16-weights / float32-activations case at ``tests/test_torch_moe.py``'s
1e-4. The flash route's plain version is held against the chunked path
at the three configs' full-width head shapes (GQA groups 8, 1 and 2,
D = 128).
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
from repro.models import init_params
from repro.models.attention import attention_forward as j_attention_forward
from repro.models.attention import sdpa as j_sdpa
from repro.models.params import count_params_analytic as j_count_params
from repro.models.params import forward
from repro.train import make_prefill_step as j_make_prefill_step
from repro.train import make_serve_step as j_make_serve_step
from repro_torch.api import lm_params_from_reference
from repro_torch.configs import MODEL_CONFIGS, get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import count_params_analytic, param_bytes
from repro_torch.models import attention as tattn
from repro_torch.models import forward as t_forward

j_forward = jax.jit(forward, static_argnums=(2,), static_argnames=("mode",))

torch.set_num_threads(2)
ARCHS = ("qwen2.5-3b", "qwen1.5-4b", "internlm2-1.8b")
BIAS_ARCHS = ("qwen2.5-3b", "qwen1.5-4b")
TOL = 1e-5
#: logits (tests/test_torch_lm.py)
LOGIT_TOL = 1e-4
#: bf16 weights under float32 activations (tests/test_torch_moe.py)
MIXED_TOL = 1e-4


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t, jnp.float32))


def with_biases(tree, seed: int = 0, scale: float = 0.5):
    """The reference's numpy tree with every ``bq`` / ``bk`` / ``bv`` leaf
    drawn from a numpy seed (standard normal times ``scale``)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (scale * rng.standard_normal(v.shape)).astype(v.dtype)
                    if k in ("bq", "bk", "bv") else walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(tree)


def _model(arch, **over):
    """(reference cfg, port cfg, reference params with drawn biases, port LM)."""
    jcfg = replace(J_CONFIGS[arch].smoke(), **over)
    tcfg = replace(MODEL_CONFIGS[arch].smoke(), **over)
    npp = with_biases(jax.tree.map(np.asarray, init_params(jax.random.key(0), jcfg)))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, npp), lm_params_from_reference(
        npp, tcfg, device="cpu")


@pytest.fixture(scope="module")
def model():
    """``model(arch)``: :func:`_model` of ``arch``, built once per module."""
    built = {}

    def get(arch):
        if arch not in built:
            built[arch] = _model(arch)
        return built[arch]

    return get


def prompts(batch, plen, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (batch, plen)).astype(np.int32)


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch, full):
    j = J_CONFIGS[arch] if full else J_CONFIGS[arch].smoke()
    t = get_config(arch) if full else get_config(arch).smoke()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.padded_vocab == j.padded_vocab and t.layer_kinds() == j.layer_kinds()
    assert t.attention.qkv_bias == (arch in BIAS_ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch, model):
    """Full and smoke counts (the biases included) equal the reference's;
    no leaf of these configs reaches 2^31 elements, so its int32 count
    does not wrap."""
    for tcfg, jcfg in ((get_config(arch), J_CONFIGS[arch]),
                       (get_config(arch).smoke(), J_CONFIGS[arch].smoke())):
        assert count_params_analytic(tcfg) == j_count_params(jcfg) == tcfg.num_params()
        assert param_bytes(tcfg) == (2 if tcfg.param_dtype == "bfloat16" else 4) * tcfg.num_params()
    _, tcfg, _, lm = model(arch)
    attn = lm.segments[0][0].attn
    assert hasattr(attn, "bq") == (arch in BIAS_ARCHS)
    assert sum(p.numel() for p in lm.parameters()) == count_params_analytic(tcfg)


@pytest.mark.parametrize("arch", BIAS_ARCHS)
def test_biases_are_zeros_at_init_and_carried_across(arch, model):
    jcfg, tcfg, jp, lm = model(arch)
    fresh = tattn.init_attention(torch.Generator().manual_seed(0), tcfg.attention,
                                 tcfg.d_model, torch.float32)
    h, hk, dh = tcfg.attention.num_heads, tcfg.attention.num_kv_heads, 64
    for name, n in (("bq", h * dh), ("bk", hk * dh), ("bv", hk * dh)):
        b = getattr(fresh, name)
        assert b.shape == (n,) and b.dtype == torch.float32 and not b.any()
        for j, layer in enumerate(lm.segments[0]):
            np.testing.assert_array_equal(getattr(layer.attn, name).numpy(),
                                          np.asarray(jp["segments"][0]["attn"][name][j]))
            assert getattr(layer.attn, name).abs().max() > 0.1


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_attention_forward_prefill_and_decode(arch, flash, model):
    """Layer 0's attention with its drawn biases: prefill over 128 tokens
    (with and without the flash switch), then one decode step into a
    136-slot cache, against the reference's."""
    jcfg, tcfg, jp, lm = model(arch)
    b, s, d = 2, 128, tcfg.d_model
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, s + 1, d), dtype=np.float32)
    pos = np.tile(np.arange(s + 1, dtype=np.int32)[None], (b, 1))
    jpa = jax.tree.map(lambda a: a[0], jp["segments"][0]["attn"])
    p = lm.segments[0][0].attn
    jy, jc = j_attention_forward(jpa, jnp.asarray(x[:, :s]), cfg=jcfg.attention, d_model=d,
                                 positions=jnp.asarray(pos[:, :s]), mode="prefill")
    with torch.no_grad():
        ty, tc = tattn.attention_forward(p, torch.from_numpy(x[:, :s]), cfg=tcfg.attention,
                                         d_model=d, positions=torch.from_numpy(pos[:, :s]),
                                         mode="prefill", use_flash_kernel=flash)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=TOL, rtol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name]), atol=TOL, rtol=TOL)

    pad = ((0, 0), (0, 8), (0, 0), (0, 0))
    jcache = {n: jnp.pad(a, pad) for n, a in jc.items()}
    tcache = {n: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 8)) for n, a in tc.items()}
    jy, jc2 = j_attention_forward(jpa, jnp.asarray(x[:, s:]), cfg=jcfg.attention, d_model=d,
                                  positions=jnp.asarray(pos[:, s:]), mode="decode",
                                  cache=jcache, cache_index=jnp.asarray(s, jnp.int32))
    with torch.no_grad():
        ty, tc2 = tattn.attention_forward(p, torch.from_numpy(x[:, s:]), cfg=tcfg.attention,
                                          d_model=d, positions=torch.from_numpy(pos[:, s:]),
                                          mode="decode", cache=tcache, cache_index=s)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=TOL, rtol=TOL)
    for name in ("k", "v"):
        assert tc2[name] is tcache[name]                  # written in place
        np.testing.assert_allclose(_np(tc2[name]), np.asarray(jc2[name]), atol=TOL, rtol=TOL)


def test_a_missing_bias_add_would_show(model):
    """The drawn biases move layer 0's output well past the tolerance: a
    port that dropped them would fail the comparisons above."""
    _, tcfg, _, lm = model("qwen2.5-3b")
    p = lm.segments[0][0].attn
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 16, tcfg.d_model),
                                                                  dtype=np.float32))
    pos = torch.arange(16, dtype=torch.int32)[None]
    kw = dict(cfg=tcfg.attention, d_model=tcfg.d_model, positions=pos)
    with torch.no_grad():
        y, _ = tattn.attention_forward(p, x, **kw)
        zero = tattn.init_attention(None, tcfg.attention, tcfg.d_model, torch.float32)
        for name, w in p.named_parameters():
            zero.get_parameter(name).copy_(torch.zeros_like(w) if name[0] == "b" else w)
        y0, _ = tattn.attention_forward(zero, x, **kw)
    assert float((y - y0).abs().max()) > 1e3 * TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_reference(arch, monkeypatch, model):
    """lm_forward in prefill mode through the flash switch: one kernel
    dispatch per layer, the logits and the K/V cache against the
    reference's prefill."""
    jcfg, tcfg, jp, lm = model(arch)
    toks = prompts(2, 128, tcfg.vocab_size, seed=5)
    jl, jc, _ = j_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg, mode="prefill")
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(a[1].shape) or real(*a, **kw))
    with torch.no_grad():
        tl, tc, _ = t_forward(lm, {"tokens": torch.from_numpy(toks)}, tcfg, mode="prefill",
                              use_flash_kernel=True)
    hk = tcfg.attention.num_kv_heads
    assert calls == [(2, 128, hk, 64)] * tcfg.num_layers          # grouped K/V
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc["segments"][0]["kv"][name]),
                                   np.asarray(jc["segments"][0]["kv"][name]), atol=TOL, rtol=TOL)


def reference_generate(jcfg, jp, toks, n_tokens):
    """The reference's serving loop (``repro/launch/serve.py``) on one
    device: prefill, its per-leaf splice, greedy decode. Returns (tokens,
    prefill's last logits, the first decode step's logits)."""
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


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_reference(arch, model):
    """8 greedy tokens after a 128-token prompt through the launcher's
    generate (flash prefill, spliced cache, in-place decode) equal the
    reference's; the last prefill logits and the first decode step's
    logits within 1e-4."""
    jcfg, tcfg, jp, lm = model(arch)
    toks = prompts(2, 128, tcfg.vocab_size, seed=7)
    want, want_logits, want_step = reference_generate(jcfg, jp, toks, 8)
    logits, cache = tserve.prefill(lm, tcfg, torch.from_numpy(toks), 136)
    np.testing.assert_allclose(_np(logits), want_logits, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    tok = tserve.greedy(logits)
    with torch.no_grad():
        step, _, _ = t_forward(lm, {"tokens": tok}, tcfg, mode="decode", cache=cache,
                               cache_index=128)
    np.testing.assert_allclose(_np(step), want_step, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    got, _ = tserve.generate(lm, tcfg, torch.from_numpy(toks), tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_weights_f32_activations_match_reference():
    """qwen2.5-3b with ``param_dtype="bfloat16"`` and
    ``compute_dtype="float32"``: the bf16 biases are added to float32
    projections in float32, as ``jnp`` promotes them; prefill logits
    within 1e-4."""
    jcfg, tcfg, jp, lm = _model("qwen2.5-3b", param_dtype="bfloat16",
                                compute_dtype="float32")
    assert lm.segments[0][0].attn.bq.dtype == torch.bfloat16
    toks = prompts(2, 128, tcfg.vocab_size, seed=8)
    jl, _, _ = j_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg, mode="prefill")
    with torch.no_grad():
        tl, _, _ = t_forward(lm, {"tokens": torch.from_numpy(toks)}, tcfg, mode="prefill",
                             use_flash_kernel=True)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=MIXED_TOL, rtol=MIXED_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_flash_route_matches_the_chunked_path_at_the_full_head_shape(arch, monkeypatch):
    """The kernel route (its plain version on the CPU) at the config's
    full-width heads (GQA group 8, 1 or 2, D = 128), causal, S = 256,
    against the port's chunked path and the reference's (q_chunk 64, so
    that both chunk)."""
    att = get_config(arch).attention
    h, hk, dh = att.num_heads, att.num_kv_heads, att.head_dim
    assert dh == 128 and h // hk == {"qwen2.5-3b": 8, "qwen1.5-4b": 1, "internlm2-1.8b": 2}[arch]
    b, s = 1, 256
    rng = np.random.default_rng(21)
    q, k, v = (rng.standard_normal((b, s, n, dh), dtype=np.float32) for n in (h, hk, hk))
    pos = np.tile(np.arange(s, dtype=np.int32)[None], (b, 1))
    scale = 1.0 / dh ** 0.5
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(a[1].shape) or real(*a, **kw))
    targs = tuple(torch.from_numpy(a) for a in (q, k, v, pos, pos))
    got = tattn.sdpa(*targs, scale=scale, causal=True, use_flash_kernel=True)
    chunked = tattn.sdpa(*targs, scale=scale, causal=True, q_chunk=64)
    assert calls == [(b, s, hk, dh)]
    want = j_sdpa(*(jnp.asarray(a) for a in (q, k, v, pos, pos)), scale=scale, causal=True,
                  q_chunk=64)
    np.testing.assert_allclose(_np(got), _np(chunked), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_smoke_on_cpu(arch, capsys):
    out = tserve.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "128",
                       "--tokens", "4", "--device", "cpu"])
    assert tuple(out.shape) == (2, 4) and out.dtype == torch.int32
    assert "generated (2, 4)" in capsys.readouterr().out
