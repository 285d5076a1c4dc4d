# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Shared setup of the paper's table drivers, the counterpart of
``benchmarks/common.py``: synthetic twins of the paper's Table 2 datasets
(aspect and density kept; ``configs/glm.py``), a timer that waits for the
card, the device-side test eval of Figure 1, and the ``name,us,derived``
emit lines.

Scales: ``twin`` is the reference's CPU-scale twins (6400 x 512, 5120 x
4096, 25600 x 128); ``tiny`` the same shapes cut so that a CPU test runs
every driver in seconds. The full-width epsilon cell is ``chip_smoke.py``'s
(phase 4's data on the card), which calls the drivers' ``run_dataset``.
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.configs.glm import GLM_DNA, GLM_EPSILON, GLM_WEBSPAM
from repro_torch.data.synthetic import GLMDataset, make_glm_dataset
from repro_torch.device import resolve_device

#: the reference's CPU-scale twins (benchmarks/common.py TWINS)
TWINS = {
    "epsilon-twin": replace(GLM_EPSILON, name="epsilon-twin",
                            citation="Table 2: epsilon (dense)", num_examples=6400,
                            num_features=512, density=1.0, avg_nnz_per_example=512),
    "webspam-twin": replace(GLM_WEBSPAM, name="webspam-twin",
                            citation="Table 2: webspam (sparse, wide)", num_examples=5120,
                            num_features=4096, density=0.02, avg_nnz_per_example=82),
    "dna-twin": replace(GLM_DNA, name="dna-twin",
                        citation="Table 2: dna (many examples, narrow)", num_examples=25600,
                        num_features=128, density=0.25, avg_nnz_per_example=32),
}
#: the same twins cut for the CPU tests: the density kept, rows and
#: features divided
TINY = {
    "epsilon-twin": replace(TWINS["epsilon-twin"], num_examples=640, num_features=64,
                            avg_nnz_per_example=64),
    "webspam-twin": replace(TWINS["webspam-twin"], num_examples=640, num_features=256,
                            avg_nnz_per_example=5),
    "dna-twin": replace(TWINS["dna-twin"], num_examples=1280, num_features=32,
                        avg_nnz_per_example=8),
}
SCALES = {"twin": TWINS, "tiny": TINY}


def load_twin(name: str, *, scale: str = "twin", device="cuda") -> GLMDataset:
    """The twin ``name`` at ``scale``, drawn on the host from a numpy
    generator seeded by ``zlib.crc32(name)`` (deterministic across
    processes) and moved to ``device``."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    return make_glm_dataset(SCALES[scale][name], rng, device=device)


@dataclass
class Timer:
    """``with Timer(device) as t: ...``: the card is synchronised when the
    clock starts and before it stops, so ``dt`` (seconds) is the work's
    wall time, not its enqueue."""

    device: object = "cpu"
    t0: float = 0.0
    dt: float = 0.0

    def __post_init__(self):
        self.cuda = resolve_device(self.device).type == "cuda"

    def __enter__(self):
        if self.cuda:
            torch.cuda.synchronize()  # allow[torch-host-sync]: a timer's fence, not a read; a driver's, outside any solve
        self.t0 = time.perf_counter()  # allow[torch-metric-discipline]: a driver's timer
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()  # allow[torch-host-sync]: a timer's fence, not a read; a driver's, outside any solve
        self.dt = time.perf_counter() - self.t0  # allow[torch-metric-discipline]: a driver's timer


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    print(f"{name},{us_per_call:.1f},{derived}")


def auprc_device(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Average precision on the scores' device (float64, a 0-d tensor):
    ``train.metrics.auprc``'s definition, with ties in the order of a
    stable descending sort."""
    order = torch.sort(-scores, stable=True).indices
    pos = (labels[order] > 0).to(torch.float64)
    k = torch.arange(1, pos.shape[0] + 1, dtype=torch.float64, device=pos.device)
    n_pos = pos.sum()
    ap = (torch.cumsum(pos, 0) / k * pos).sum() / n_pos.clamp_min(1.0)
    return torch.where(n_pos > 0, ap, torch.zeros_like(ap))


def make_device_eval(X_test: torch.Tensor, y_test: torch.Tensor):
    """Figure 1's eval for both systems: ``fn(beta) -> {"auprc",
    "accuracy", "nnz", "finite"}`` scored on the test matrix's device, with
    one counted host read (``engine.host_read``) per call; nnz counts
    |beta| > 1e-8, as the reference's TG rows do; "finite" says every
    coefficient is finite."""
    from repro_torch.core import engine

    def fn(beta):
        beta = torch.as_tensor(beta, dtype=torch.float32, device=X_test.device)
        scores = X_test @ beta
        acc = ((scores > 0) == (y_test > 0)).to(torch.float64).mean()
        nnz = (beta.abs() > 1e-8).sum().to(torch.float64)
        finite = torch.isfinite(beta).all().to(torch.float64)
        auprc, accuracy, n, ok = engine.host_read(torch.stack(
            [auprc_device(scores, y_test), acc, nnz, finite]))
        return {"auprc": auprc, "accuracy": accuracy, "nnz": int(n), "finite": bool(ok)}

    return fn
