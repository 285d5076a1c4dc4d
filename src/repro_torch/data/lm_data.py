# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Synthetic LM token pipeline (counterpart of ``repro/data/lm_data.py``):
Zipf-distributed corpora with enough structure (Markov bigram mixing)
that loss visibly decreases during training, and a batch iterator that
puts each batch on the training device.

The corpus is drawn with numpy exactly as the reference draws it, so the
same ``numpy.random.Generator`` gives the same tokens in both packages.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device


def zipf_corpus(
    rng: np.random.Generator, vocab: int, length: int, *, alpha: float = 1.1,
    bigram_coherence: float = 0.6,
) -> np.ndarray:
    """Tokens with Zipf marginals and a deterministic bigram component:
    with prob `bigram_coherence`, next = (prev * 31 + 7) % vocab — learnable
    structure for loss-decrease assertions."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks**alpha
    probs /= probs.sum()
    iid = rng.choice(vocab, size=length, p=probs)
    out = iid.copy()
    coh = rng.random(length) < bigram_coherence
    for t in range(1, length):
        if coh[t]:
            out[t] = (out[t - 1] * 31 + 7) % vocab
    return out.astype(np.int32)


def batches(
    corpus: np.ndarray,
    batch: int,
    seq_len: int,
    *,
    cfg: Optional[ModelConfig] = None,
    rng: Optional[np.random.Generator] = None,
    device=DEFAULT_DEVICE,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Yields {"tokens", "labels"}, (batch, seq_len) int32 on ``device``:
    a random window of the corpus and the same window shifted by one.
    Frontend (vlm, audio) and encoder-decoder configs raise here: their
    embeddings come with the models that take them."""
    if cfg is not None and cfg.encdec.enabled:
        raise NotImplementedError("encoder-decoder batches are not ported yet "
                                  "(queue 1 item 5.8)")
    if cfg is not None and cfg.frontend.kind != "none":
        raise NotImplementedError("frontend embedding batches are not ported yet "
                                  "(queue 1 item 5.7)")
    dev = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    n_tok = batch * (seq_len + 1)

    def gen():
        while True:
            starts = rng.integers(0, len(corpus) - n_tok - 1)
            window = corpus[starts: starts + n_tok].reshape(batch, seq_len + 1)
            tokens = torch.from_numpy(window[:, :-1].astype(np.int32)).to(dev)
            labels = torch.from_numpy(window[:, 1:].astype(np.int32)).to(dev)
            yield {"tokens": tokens, "labels": labels}

    return gen()
