"""The port's Mamba2 SSD slice (mamba2-2.7b) on the CPU, against the JAX
package on the same weights and inputs.

Inputs are drawn once from a numpy seed and fed to both packages; the
block's weights are mamba2's ``smoke()`` model's, drawn by the reference
and carried over by ``api.convert.lm_params_from_reference``. Tolerance
1e-5 for the pieces and the block in every mode (float32, sums in
another order than XLA's), 1e-4 for the smoke model's prefill logits
(``tests/test_torch_lm.py``'s bound) and for prefill-then-decode against
the longer prefill (``tests/test_models.py``'s own atol); greedy tokens
equal.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MODEL_CONFIGS as J_CONFIGS
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import ssm as jssm
from repro.models.layers import gated_rmsnorm as j_gated_rmsnorm
from repro.models.params import forward
from repro.train import make_prefill_step as j_make_prefill_step
from repro.train import make_serve_step as j_make_serve_step
from repro_torch.api import lm_params_from_reference
from repro_torch.configs import MODEL_CONFIGS
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import forward as t_forward
from repro_torch.models import init_cache
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm

# the reference's functions compiled once per configuration: eager JAX
# compiles every op anew for each shape
j_ssd_chunked = jax.jit(jssm.ssd_chunked, static_argnames=("chunk",))
j_mamba2_forward = jax.jit(jssm.mamba2_forward, static_argnames=("cfg", "d_model", "mode"))
j_forward = jax.jit(forward, static_argnums=(2,), static_argnames=("mode",))

torch.set_num_threads(2)
ARCH = "mamba2-2.7b"
TOL = 1e-5
LOGIT_TOL = 1e-4


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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol, err_msg=what)


@pytest.fixture(scope="module")
def smoke():
    """(reference cfg, port cfg, reference params, port LM)."""
    jcfg, tcfg = J_CONFIGS[ARCH].smoke(), MODEL_CONFIGS[ARCH].smoke()
    jp = j_init_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jp, lm_params_from_reference(jax.tree.map(np.asarray, jp), tcfg,
                                                    device="cpu")


def test_smoke_model_is_pure_ssd(smoke):
    _, tcfg, jp, lm = smoke
    assert tcfg.layer_kinds() == ("ssm", "ssm") and tcfg.tie_embeddings
    m = lm.segments[0][1].mamba
    for name in ("A_log", "D", "dt_bias"):
        assert getattr(m, name).dtype == torch.float32
        np.testing.assert_array_equal(getattr(m, name).numpy(),
                                      np.asarray(jp["segments"][0]["mamba"][name][1]))
    assert not hasattr(lm, "lm_head")


@pytest.mark.parametrize("shape", [(2, 7, 48), (1, 3, 512)])
def test_gated_rmsnorm(shape):
    rng = np.random.default_rng(1)
    x, gate = (rng.standard_normal(shape, dtype=np.float32) * 2 for _ in range(2))
    scale = rng.standard_normal(shape[-1], dtype=np.float32)
    got = tlayers.gated_rmsnorm(_t(scale), _t(x), _t(gate))
    want = j_gated_rmsnorm(jnp.asarray(scale), jnp.asarray(x), jnp.asarray(gate))
    _close(got, want)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    rng = np.random.default_rng(2)
    xbc = rng.standard_normal((2, 9, 40), dtype=np.float32)
    w = rng.standard_normal((4, 40), dtype=np.float32) * 0.3
    b = rng.standard_normal(40, dtype=np.float32) * 0.1
    st = rng.standard_normal((2, 3, 40), dtype=np.float32) if with_state else None
    got, got_state = tssm._causal_conv(_t(xbc), _t(w), _t(b), None if st is None else _t(st))
    want, want_state = jssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b),
                                         None if st is None else jnp.asarray(st))
    _close(got, want)
    np.testing.assert_array_equal(_np(got_state), np.asarray(want_state))


def _ssd_inputs(seed, b=2, s=32, h=8, p=4, g=2, n=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)).astype(np.float32) - 1.0))
    a = -np.exp(rng.uniform(0.0, 2.0, h)).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, g, n), dtype=np.float32) for _ in range(2))
    st = rng.standard_normal((b, h, p, n), dtype=np.float32)
    return x, dt.astype(np.float32), a, bm, cm, st


@pytest.mark.parametrize("chunk,groups,init_state", [(8, 1, False), (16, 1, True),
                                                    (8, 2, True), (16, 2, False)])
def test_ssd_chunked(chunk, groups, init_state):
    x, dt, a, bm, cm, st = _ssd_inputs(3, g=groups)
    init = st if init_state else None
    got_y, got_s = tssm.ssd_chunked(_t(x), _t(dt), _t(a), _t(bm), _t(cm), chunk=chunk,
                                    init_state=None if init is None else _t(init))
    want_y, want_s = j_ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)),
                                      chunk=chunk,
                                      init_state=None if init is None else jnp.asarray(init))
    _close(got_y, want_y, what="y")
    _close(got_s, want_s, what="state")


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_decode_step(groups):
    x, dt, a, bm, cm, st = _ssd_inputs(4, s=1, g=groups)
    got_y, got_s = tssm.ssd_decode_step(_t(x), _t(dt), _t(a), _t(bm), _t(cm), _t(st))
    want_y, want_s = jssm.ssd_decode_step(*(jnp.asarray(v) for v in (x, dt, a, bm, cm, st)))
    _close(got_y, want_y, what="y")
    _close(got_s, want_s, what="state")


@pytest.mark.parametrize("chunk,s", [(8, 64), (32, 64), (32, 40), (8, 13)])
def test_mamba2_forward_every_mode(smoke, chunk, s):
    """Layer 1's block in train and prefill mode (S = 40 and 13 need
    padding to the chunk), then one decode step from
    the prefill's states, against the reference's, and the decode step
    against the longer prefill's last position."""
    jcfg, tcfg, jp, lm = smoke
    jc, tc = replace(jcfg.ssm, chunk_size=chunk), replace(tcfg.ssm, chunk_size=chunk)
    d = tcfg.d_model
    jm = jax.tree.map(lambda a: jnp.asarray(a[1]), jp["segments"][0]["mamba"])
    tm = lm.segments[0][1].mamba
    x = np.random.default_rng(5).standard_normal((2, s + 1, d), dtype=np.float32)
    kw = dict(d_model=d)
    with torch.no_grad():
        ty, tcache = tssm.mamba2_forward(tm, _t(x[:, :s]), cfg=tc, mode="train", **kw)
        assert tcache is None
        jy, _ = j_mamba2_forward(jm, jnp.asarray(x[:, :s]), cfg=jc, mode="train", **kw)
        _close(ty, jy, what="train")

        ty, tcache = tssm.mamba2_forward(tm, _t(x[:, :s]), cfg=tc, mode="prefill", **kw)
        jy, jcache = j_mamba2_forward(jm, jnp.asarray(x[:, :s]), cfg=jc, mode="prefill", **kw)
        _close(ty, jy, what="prefill")
        for name in ("conv", "ssd"):
            _close(tcache[name], jcache[name], what=name)
        assert tcache["ssd"].dtype == torch.float32

        held = {k: v.clone() for k, v in tcache.items()}
        ty, tc2 = tssm.mamba2_forward(tm, _t(x[:, s:]), cfg=tc, mode="decode", cache=held, **kw)
        jy, jc2 = j_mamba2_forward(jm, jnp.asarray(x[:, s:]), cfg=jc, mode="decode",
                                      cache=jcache, **kw)
        assert tc2 is held and tc2["conv"] is held["conv"]         # written in place
        _close(ty, jy, what="decode")
        for name in ("conv", "ssd"):
            _close(tc2[name], jc2[name], what=f"decode {name}")
        full, _ = tssm.mamba2_forward(tm, _t(x), cfg=tc, mode="train", **kw)
        np.testing.assert_allclose(_np(ty[:, 0]), _np(full[:, s]), atol=LOGIT_TOL)


def test_ssm_cache_layout(smoke):
    _, tcfg, _, _ = smoke
    c = init_cache(tcfg, 3, 40, device="cpu")["segments"][0]["ssm"]
    ssm, d = tcfg.ssm, tcfg.d_model
    conv_dim = ssm.d_inner(d) + 2 * ssm.ngroups * ssm.d_state
    assert c["conv"].shape == (2, 3, ssm.conv_width - 1, conv_dim)
    assert c["ssd"].shape == (2, 3, ssm.num_heads(d), ssm.head_dim, ssm.d_state)
    assert c["ssd"].dtype == torch.float32 and c["conv"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the slice: prefill, splice and greedy decode against the reference's flow
# ---------------------------------------------------------------------------


def prompts(batch, plen, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (batch, plen)).astype(np.int32)


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


def test_prefill_logits_match_reference(smoke, monkeypatch):
    """Prefill of the whole model (S = 100: padded to the chunk) with the
    flash switch on: no attention layer, so no kernel dispatch; logits and
    the stacked SSM states against the reference's."""
    jcfg, tcfg, jp, lm = smoke
    toks = prompts(2, 100, tcfg.vocab_size, seed=5)
    jl, jc, jaux = j_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg, mode="prefill")
    calls = []
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **kw: calls.append(1))
    with torch.no_grad():
        tl, tc, taux = t_forward(lm, {"tokens": torch.from_numpy(toks)}, tcfg, mode="prefill",
                               use_flash_kernel=True)
    assert not calls and taux == {} == jaux
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for name in ("conv", "ssd"):
        got, want = tc["segments"][0]["ssm"][name], jc["segments"][0]["ssm"][name]
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_TOL, err_msg=name)


def test_greedy_tokens_equal_reference(smoke):
    jcfg, tcfg, jp, lm = smoke
    toks = prompts(2, 128, tcfg.vocab_size, seed=7)
    want, want_logits = reference_generate(jcfg, jp, toks, 8)
    logits, cache = tserve.prefill(lm, tcfg, torch.from_numpy(toks), 136)
    np.testing.assert_allclose(_np(logits), want_logits, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    got, _ = tserve.generate(lm, tcfg, torch.from_numpy(toks), tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_after_prefill_equals_longer_prefill(smoke):
    """The model's prefill of P tokens then one decode step against a
    prefill of P + 1 tokens (``tests/test_models.py``'s SSD check, at
    its atol, through the whole model and the launcher's splice)."""
    _, tcfg, _, lm = smoke
    toks = torch.from_numpy(prompts(2, 97, tcfg.vocab_size, seed=9))
    with torch.no_grad():
        full, _, _ = t_forward(lm, {"tokens": toks}, tcfg, mode="prefill")
        _, cache = tserve.prefill(lm, tcfg, toks[:, :96], 97)
        dec, _, _ = t_forward(lm, {"tokens": toks[:, 96:]}, tcfg, mode="decode", cache=cache,
                            cache_index=96)
    np.testing.assert_allclose(_np(dec[:, 0]), _np(full[:, 96]), atol=LOGIT_TOL)


def test_launcher_smoke_on_cpu(capsys):
    out = tserve.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "128",
                       "--tokens", "4", "--device", "cpu"])
    assert tuple(out.shape) == (2, 4) and out.dtype == torch.int32
    assert "generated (2, 4)" in capsys.readouterr().out
