"""The port's sparse probe (``core/probe.py``) and the LM's split into
hidden states and head, against the JAX package.

Features: tinyllama's float32 ``smoke()`` model (2 layers, d_model 256)
with the reference's weights carried over by ``lm_params_from_reference``,
pooled by mean and by last position, within 1e-4 (products summed in
another order than XLA's; ``tests/test_torch_lm.py``'s logit tolerance).
The readout's fit and path on seeded numpy features are held at the
reference's fit-vs-fit tolerances (relative objective gap < 1e-4, betas
within rtol 1e-2 / atol 1e-3; path lambdas within rtol 1e-6).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MODEL_CONFIGS as J_CONFIGS
from repro.core.dglmnet import DGLMNETOptions as JOptions
from repro.core.probe import extract_features as j_extract_features
from repro.core.probe import probe_path as j_probe_path
from repro.core.probe import train_sparse_probe as j_train_sparse_probe
from repro.models import init_params as j_init_params
from repro_torch.api import lm_params_from_reference
from repro_torch.configs import MODEL_CONFIGS
from repro_torch.core.dglmnet import DGLMNETOptions
from repro_torch.core.probe import extract_features, probe_path, train_sparse_probe
from repro_torch.models.layers import apply_norm
from repro_torch.models.blocks import layer_forward
from repro_torch.models.transformer import (dtype_of, lm_forward, lm_head, lm_hidden,
                                            segments_of)

torch.set_num_threads(2)
ARCH = "tinyllama-1.1b"
FEATURE_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = J_CONFIGS[ARCH].smoke()
    tcfg = MODEL_CONFIGS[ARCH].smoke()
    jp = j_init_params(jax.random.key(0), jcfg)
    npp = jax.tree.map(np.asarray, jp)
    return jcfg, tcfg, jp, lm_params_from_reference(npp, tcfg, device="cpu")


def _tokens(cfg, b=3, s=24, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(8, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("pool", ["mean", "last"])
def test_features_match_reference(models, pool):
    jcfg, tcfg, jp, lm = models
    tok = _tokens(tcfg)
    want = j_extract_features(jp, jcfg, jnp.asarray(tok), pool=pool)
    got = extract_features(lm, tcfg, torch.from_numpy(tok), pool=pool)
    assert got.shape == (3, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FEATURE_TOL,
                               atol=FEATURE_TOL)


def _lm_forward_before_split(params, tokens, cfg):
    """``lm_forward``'s train-mode body as it stood before the split."""
    x = torch.nn.functional.embedding(tokens, params.embed).to(dtype_of(cfg.compute_dtype))
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32)[None, :].expand(b, s)
    for i, (kind, _) in enumerate(segments_of(cfg)):
        for layer in params.segments[i]:
            x, _, _ = layer_forward(layer, x, cfg=cfg, kind=kind, positions=positions,
                                    mode="train", cache=None, cache_index=None,
                                    window=cfg.attention.sliding_window,
                                    use_flash_kernel=False)
    h = apply_norm(params.final_norm, x, eps=cfg.norm_eps)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return h @ head.to(h.dtype)


def test_logits_bit_equal_across_the_split(models):
    _, tcfg, _, lm = models
    tok = torch.from_numpy(_tokens(tcfg, seed=4))
    with torch.no_grad():
        logits, _, _ = lm_forward(lm, {"tokens": tok}, tcfg)
        h, _ = lm_hidden(lm, {"tokens": tok}, tcfg)
        before = _lm_forward_before_split(lm, tok, tcfg)
    assert torch.equal(logits, before)
    assert torch.equal(lm_head(lm, h, tcfg), logits)


def test_unported_branches_raise(models):
    _, tcfg, _, lm = models
    tok = torch.from_numpy(_tokens(tcfg))
    with pytest.raises(ValueError):
        extract_features(lm, tcfg, tok, pool="max")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        extract_features(lm, tcfg, tok, extra_inputs={"frame_embeds": torch.zeros(3, 4, 8)})
    encdec = replace(tcfg, encdec=replace(tcfg.encdec, enabled=True))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        extract_features(lm, encdec, tok)


@pytest.fixture(scope="module")
def probe_data():
    """Seeded features with a sparse logistic truth (600 x 64)."""
    rng = np.random.default_rng(11)
    F = rng.standard_normal((600, 64)).astype(np.float32)
    truth = np.zeros(64)
    truth[:6] = rng.standard_normal(6) * 2
    y = np.where(rng.random(600) < 1 / (1 + np.exp(-F @ truth)), 1.0, -1.0).astype(np.float32)
    return F, y


OPTS = dict(num_blocks=4, tile=16, max_iters=150, rel_tol=1e-8)


def test_train_sparse_probe_matches_reference(probe_data):
    F, y = probe_data
    want = j_train_sparse_probe(jnp.asarray(F), jnp.asarray(y), opts=JOptions(**OPTS))
    got = train_sparse_probe(F, y, opts=DGLMNETOptions(**OPTS), device="cpu")
    assert got.ok and want.ok
    assert abs(got.f - want.f) / abs(want.f) < 1e-4, (got.f, want.f)
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(want.beta), rtol=1e-2, atol=1e-3)


def test_probe_path_matches_reference(probe_data):
    F, y = probe_data
    want = j_probe_path(jnp.asarray(F), jnp.asarray(y), path_len=5, opts=JOptions(**OPTS))
    got = probe_path(F, y, path_len=5, opts=DGLMNETOptions(**OPTS), device="cpu")
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got.lambdas, np.asarray(want.lambdas), rtol=1e-6)
    for a, b in zip(got, want):
        assert a.ok and b.ok and a.nnz == b.nnz, (a.nnz, b.nnz)
        assert abs(a.f - b.f) / abs(b.f) < 1e-4, (a.f, b.f)
        np.testing.assert_allclose(a.beta.numpy(), np.asarray(b.beta), rtol=1e-2, atol=1e-3)
