# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Synthetic classification data: twins of the paper's Table 2 datasets,
the recipe of ``repro/data/synthetic.py`` ``make_glm_dataset``.

Gaussian X (Bernoulli-masked below density 1), a sparse ground truth with
``k_true = max(4, p // 20)`` informative features scaled by ``snr``,
logistic labels in {-1, +1} with a share ``label_noise`` flipped, and
the first ``test_frac`` of the rows held out.

Two sources of random numbers:

* a ``numpy.random.Generator``: draws on the host, so a test can hand
  the same arrays to the JAX package;
* a ``torch.Generator``: draws on the generator's device, so a
  full-size X is made on the card with no host->device copy.

Neither reproduces ``jax.random``'s bits.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import GLMConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device


@dataclass
class GLMDataset:
    X_train: torch.Tensor
    y_train: torch.Tensor
    X_test: torch.Tensor
    y_test: torch.Tensor
    beta_true: torch.Tensor
    name: str = "synthetic"

    @property
    def nnz(self) -> int:
        return int((self.X_train != 0).sum() + (self.X_test != 0).sum())


class _NumpyDraws:
    def __init__(self, rng: np.random.Generator):
        self.rng = rng
        self.device = torch.device("cpu")

    def normal(self, shape):
        return torch.from_numpy(self.rng.standard_normal(shape, dtype=np.float32))

    def uniform(self, shape):
        return torch.from_numpy(self.rng.random(shape, dtype=np.float32))

    def choice(self, p: int, k: int):
        return torch.from_numpy(self.rng.choice(p, k, replace=False))


class _TorchDraws:
    def __init__(self, gen: torch.Generator):
        self.gen = gen
        self.device = gen.device

    def normal(self, shape):
        return torch.randn(shape, generator=self.gen, device=self.device)

    def uniform(self, shape):
        return torch.rand(shape, generator=self.gen, device=self.device)

    def choice(self, p: int, k: int):
        return torch.randperm(p, generator=self.gen, device=self.device)[:k]


def make_glm_dataset(
    cfg: GLMConfig,
    gen,
    *,
    device=DEFAULT_DEVICE,
    test_frac: float = 0.2,
    k_true: int = 0,
    label_noise: float = 0.05,
    snr: float = 3.0,
) -> GLMDataset:
    """``gen`` is a ``numpy.random.Generator`` or a ``torch.Generator``
    on ``device``. Returns float32 tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(gen, np.random.Generator):
        draws = _NumpyDraws(gen)
    elif isinstance(gen, torch.Generator):
        if gen.device.type != dev.type:
            raise ValueError(
                f"torch.Generator lives on {gen.device}, the data is asked "
                f"for on {dev}: make the generator on the data's device")
        draws = _TorchDraws(gen)
    else:
        raise TypeError(f"gen must be a numpy or torch Generator, got {type(gen)}")

    n, p = cfg.num_examples, cfg.num_features
    k_true = k_true or max(4, p // 20)

    X = draws.normal((n, p))
    if cfg.density < 1.0:
        X = torch.where(draws.uniform((n, p)) < cfg.density, X, 0.0)

    beta_true = torch.zeros(p, dtype=torch.float32, device=draws.device)
    idx = draws.choice(p, k_true)
    scale = snr / np.sqrt(k_true * max(cfg.density, 1e-6))
    beta_true[idx] = draws.normal((k_true,)) * np.float32(scale)

    prob = torch.sigmoid(X @ beta_true)
    y = torch.where(draws.uniform((n,)) < prob, 1.0, -1.0)
    if label_noise:
        y = torch.where(draws.uniform((n,)) < label_noise, -y, y)

    X, y, beta_true = X.to(dev), y.to(dev), beta_true.to(dev)
    n_test = int(n * test_frac)
    return GLMDataset(
        X_train=X[n_test:], y_train=y[n_test:],
        X_test=X[:n_test], y_test=y[:n_test],
        beta_true=beta_true, name=cfg.name,
    )
