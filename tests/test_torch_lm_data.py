"""The port's synthetic LM token pipeline (``repro_torch.data.lm_data``)
against the JAX package's (``repro.data.lm_data``): the same numpy
generator gives the same corpus, bit for bit, and the same batches."""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro.data.lm_data import batches as j_batches
from repro.data.lm_data import zipf_corpus as j_zipf_corpus
from repro_torch.configs import MODEL_CONFIGS
from repro_torch.configs.base import EncDecConfig, FrontendStub
from repro_torch.data.lm_data import batches, zipf_corpus

ARCH = "tinyllama-1.1b"


@pytest.mark.parametrize("vocab,length,seed", [(512, 5000, 0), (32000, 20000, 7)])
def test_zipf_corpus_is_bit_equal(vocab, length, seed):
    got = zipf_corpus(np.random.default_rng(seed), vocab, length)
    want = j_zipf_corpus(np.random.default_rng(seed), vocab, length)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # the bigram component is there: next == (prev * 31 + 7) % vocab often
    assert np.mean(got[1:] == (got[:-1] * 31 + 7) % vocab) > 0.5


def test_batches_match_the_reference():
    corpus = zipf_corpus(np.random.default_rng(0), 512, 10_000)
    cfg = MODEL_CONFIGS[ARCH].smoke()
    got = batches(corpus, 3, 16, cfg=cfg, rng=np.random.default_rng(5), device="cpu")
    want = j_batches(corpus, 3, 16, cfg=cfg, rng=np.random.default_rng(5))
    for _ in range(4):
        g, w = next(got), next(want)
        assert sorted(g) == sorted(w) == ["labels", "tokens"]
        for k in g:
            assert g[k].dtype == torch.int32 and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
        np.testing.assert_array_equal(g["tokens"][:, 1:].numpy(), g["labels"][:, :-1].numpy())


def test_batches_default_rng_matches_the_reference():
    corpus = zipf_corpus(np.random.default_rng(1), 512, 4000)
    g = next(batches(corpus, 2, 8, device="cpu"))
    w = next(j_batches(corpus, 2, 8))
    np.testing.assert_array_equal(g["tokens"].numpy(), np.asarray(w["tokens"]))


@pytest.mark.parametrize("what", ["frontend", "encdec"])
def test_unported_batch_kinds_raise(what):
    cfg = MODEL_CONFIGS[ARCH].smoke()
    if what == "frontend":
        cfg = replace(cfg, frontend=FrontendStub(kind="vision_patches", tokens_per_item=4,
                                                 embed_dim=8))
        item = "5.7"
    else:
        cfg = replace(cfg, encdec=EncDecConfig(enabled=True))
        item = "5.8"
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        batches(np.zeros(1000, np.int32), 2, 8, cfg=cfg, device="cpu")
