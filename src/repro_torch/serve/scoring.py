# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Batched path scoring, one kernel launch per request batch: the
counterpart of ``repro/serve/scoring.py``.

A :class:`~repro_torch.serve.ingest.PackedBatch` (the by-feature slab
layout of the training kernels, request rows as the example axis) goes
to the store's device through ``data.residency.put_slab`` (pinned
staging) and scored by ``kernels.ops.slab_path_spmv`` (which sorts the
slots by row first), each request reading its own row of the stacked
path:

* a local store: one launch over the (p_pad, K) slab as one batch row;
* a store on a (1, M) mesh: the slab as (M, p_pad / M, K) and the stack
  as (L, M, p_pad / M), one launch for all M blocks, then the blocks'
  partial scores summed in a fixed order (:func:`make_path_margins`, the
  shape of ``core.distributed.make_slab_margins``).

Because the kernel's path mode keeps ``slab_spmv``'s products and sum
order, a batch whose rows all ask for lambda ``l`` scores bit-identically
to ``LogisticL1.decision_function(design, beta=path[l])`` on the same
slabs, locally and through the mesh. The scores are the loop's one read
of the device per batch (``core.engine.host_read``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.data.residency import put_slab
from repro_torch.kernels import ops as kops
from repro_torch.obs import trace as obs_trace
from repro_torch.resilience.inject import serve_delay
from repro_torch.serve.ingest import PackedBatch
from repro_torch.serve.store import PathStore, StoreSnapshot


class NonFiniteScores(RuntimeError):
    """Every snapshot the scorer tried gave NaN/Inf scores for this batch.
    Raised only after the store was pinned back to its last-good snapshot
    (where one existed) and the batch rescored, so the batch itself is
    suspect."""


def stage_batch(batch: PackedBatch, lam_idx: np.ndarray, device):
    """The batch's (p_pad, DP, K) slab pair and ``lam_idx`` on ``device``,
    copied from pinned host memory without blocking the host."""
    rows, vals = put_slab(torch.from_numpy(batch.row_idx), torch.from_numpy(batch.values),
                          device)
    idx = torch.from_numpy(lam_idx)
    if torch.device(device).type == "cuda":
        idx = idx.pin_memory().to(device, non_blocking=True)
    return rows, vals, idx


def make_path_margins(mesh, n_loc: int):
    """``path_margins(row_idx, values, lam_idx, betas) -> scores`` over a
    (p_pad, 1, K) request slab and the (L, p_pad) stack on a (1, M) mesh:
    ``core.distributed.make_slab_margins`` with the coefficient vector
    replaced by the stack and a per-row point index. One launch for the M
    feature blocks, their partial scores summed in a fixed order."""
    num_blocks = mesh.shape["model"]

    def path_margins(row_idx, values, lam_idx, betas):
        p, _, k = row_idx.shape
        if p % num_blocks:
            raise ValueError(f"p={p} must be a multiple of M={num_blocks}")
        rows = row_idx[:, 0].reshape(num_blocks, p // num_blocks, k)
        vals = values[:, 0].reshape(num_blocks, p // num_blocks, k)
        stack = betas.reshape(betas.shape[0], num_blocks, p // num_blocks)
        return kops.slab_path_spmv(rows, vals, lam_idx, stack, n_loc=n_loc).sum(0)

    return path_margins


class PathScorer:
    """Scores request batches against a :class:`PathStore`. Each attempt
    reads one store snapshot and resolves lambdas and scores against it,
    so a concurrent ``PathStore.swap`` never mixes versions inside a
    batch; the returned version names the path the batch was scored
    with."""

    def __init__(self, store: PathStore):
        self.store = store

    def score(self, batch: PackedBatch, lams) -> Tuple[np.ndarray, int]:
        """Score a packed batch; ``lams[i]`` is row i's requested lambda.

        Returns ``(scores, version)``: the ``(n_live,)`` margins x_i^T
        beta_{lam_i} (sigmoid them for probabilities) and the store
        version used for every row.

        Non-finite guard: the scores cross to the host here anyway (the
        loop's one read per batch), so they are checked first. A snapshot
        that gives NaN/Inf is quarantined -- the store pins back to its
        last-good snapshot -- and the batch is rescored; only when no
        snapshot is left does :class:`NonFiniteScores` escape.

        The ``score(rows=n_live)`` span closes at that read, so tracing
        adds none; it carries the version scored with."""
        with obs_trace.span("score", rows=int(batch.n_live)) as sp:
            scores, version = self._score(batch, lams)
            sp.set(version=version)
            return scores, version

    def _score(self, batch: PackedBatch, lams) -> Tuple[np.ndarray, int]:
        lams = np.asarray(lams, np.float64).reshape(-1)
        if lams.shape[0] != batch.n_live:
            raise ValueError(f"{lams.shape[0]} lambdas for {batch.n_live} requests")
        while True:
            snap = self.store.snapshot      # one read per attempt
            if batch.p != snap.p:
                raise ValueError(
                    f"batch hashed to p={batch.p} but the store serves p={snap.p}")
            if batch.p_pad != snap.p_pad:
                raise ValueError(
                    f"batch feature padding {batch.p_pad} != store padding "
                    f"{snap.p_pad} -- pack with pad_p_to=store.pad_p_to")
            # lambdas resolve against the snapshot actually scored with
            lam_idx = np.zeros(batch.batch_cap, np.int32)
            if batch.n_live:
                lam_idx[:batch.n_live] = snap.indices_of(lams)
            serve_delay()                   # the chaos drills' latency injection point
            scores = np.asarray(engine.host_read(self._dispatch(batch, lam_idx, snap)),
                                np.float32)
            live = scores[:batch.n_live]
            if np.all(np.isfinite(live)):
                return live, snap.version
            # each quarantine() retires one version, so this ends
            if not self.store.quarantine(snap.version):
                raise NonFiniteScores(
                    f"non-finite scores from path version {snap.version} and no "
                    f"last-good snapshot left to pin to")

    def _dispatch(self, batch: PackedBatch, lam_idx: np.ndarray, snap: StoreSnapshot):
        """The batch's (batch_cap,) scores on the store's device, one
        ``slab_path_spmv`` launch."""
        if batch.dp != 1:
            raise ValueError(f"scoring needs dp=1 slabs (one card), got dp={batch.dp}")
        rows, vals, idx = stage_batch(batch, lam_idx, snap.betas.device)
        if self.store.mesh is None:
            return kops.slab_path_spmv(rows[:, 0], vals[:, 0], idx, snap.betas,
                                       n_loc=batch.n_loc)
        return make_path_margins(self.store.mesh, batch.n_loc)(rows, vals, idx, snap.betas)
