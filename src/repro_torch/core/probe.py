# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Sparse logistic probes: the paper's technique applied to the model zoo,
the counterpart of ``repro/core/probe.py``.

Freeze a backbone, extract pooled hidden features, and train an
L1-regularized logistic readout with d-GLMNET -- feature blocks sharded
exactly like the paper's S_m. This is the modern deployment of the
paper's problem class (n large, p = d_model).

The port's LMs are decoder-only: the encoder-decoder branch and frontend
embeddings raise ``NotImplementedError``, as ``models/transformer.py``
does. ``use_flash_kernel`` sends each layer's attention through the flash
kernel where the shape qualifies (the reference's model never reaches its
Pallas attention, so the default False keeps parity).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dglmnet import DGLMNETOptions, FitResult
from repro_torch.device import DEFAULT_DEVICE, resolve_device


@torch.no_grad()
def extract_features(params, cfg: ModelConfig, tokens: torch.Tensor,
                     extra_inputs: Optional[dict] = None, pool: str = "mean", *,
                     use_flash_kernel: bool = False) -> torch.Tensor:
    """(B, S) tokens -> (B, d_model) pooled pre-logit features, in the
    model's compute type, on the tokens' device."""
    inputs = {"tokens": tokens, **(extra_inputs or {})}
    hidden = _hidden_features(params, inputs, cfg, use_flash_kernel=use_flash_kernel)
    if pool == "mean":
        return hidden.mean(dim=1)
    if pool == "last":
        return hidden[:, -1, :]
    raise ValueError(pool)


def _hidden_features(params, inputs, cfg: ModelConfig, *, use_flash_kernel: bool = False):
    """Final-norm hidden states (B, S, D)."""
    if cfg.encdec.enabled:
        raise NotImplementedError("the encoder-decoder probe (encoder memory) is not "
                                  "ported yet")
    if any(inputs.get(k) is not None for k in ("patch_embeds", "frame_embeds")):
        raise NotImplementedError("probe features over frontend embeddings are not "
                                  "ported yet")
    from repro_torch.models.transformer import lm_hidden

    h, _ = lm_hidden(params, inputs, cfg, mode="train", use_flash_kernel=use_flash_kernel)
    return h


def train_sparse_probe(
    features: torch.Tensor,          # (n, p) frozen backbone features
    labels: torch.Tensor,            # (n,) in {-1, +1}
    *,
    lam: Optional[float] = None,
    opts: DGLMNETOptions = DGLMNETOptions(num_blocks=8, tile=32),
    device=DEFAULT_DEVICE,
) -> FitResult:
    """One d-GLMNET fit of the readout; ``lam`` defaults to lambda_max / 64
    (one counted host read)."""
    from repro_torch.api import DenseDesign, LogisticL1, lambda_max_design
    from repro_torch.core import engine

    dev = resolve_device(device)
    design = DenseDesign(torch.as_tensor(features).to(device=dev, dtype=torch.float32))
    labels = torch.as_tensor(labels, dtype=torch.float32, device=dev)
    if lam is None:
        lam = engine.host_read(lambda_max_design(design, labels)) / 64
    return LogisticL1(opts=opts, device=device).fit(design, labels, lam)


def probe_path(features, labels, *, path_len=10, opts=None, eval_fn=None,
               device=DEFAULT_DEVICE):
    """The screened regularization path of the readout
    (``LogisticL1.path``)."""
    from repro_torch.api import DenseDesign, LogisticL1

    opts = opts or DGLMNETOptions(num_blocks=8, tile=32)
    dev = resolve_device(device)
    return LogisticL1(opts=opts, device=device).path(
        DenseDesign(torch.as_tensor(features).to(device=dev, dtype=torch.float32)),
        torch.as_tensor(labels, dtype=torch.float32, device=dev),
        path_len=path_len, eval_fn=eval_fn)
