# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Device-resident coefficient store for the certified regularization
path, the counterpart of ``repro/serve/store.py``.

Serving keeps the whole stacked ``(L, p)`` coefficient path on the
store's device, so every request picks its lambda at scoring time with
no host traffic: the scoring kernel reads each request's row of the
stack (``kernels.ops.slab_path_spmv``).

Hot swap: :meth:`PathStore.swap` builds the new device stack first and
then publishes it with one reference assignment. A scorer reads one
:class:`StoreSnapshot` per attempt, so a batch in flight keeps the
coefficients it started with -- a batch never mixes two versions --
and the next batch sees the new version. The store keeps the last good
snapshot for :meth:`PathStore.quarantine`; an older stack is freed when
the last batch holding its snapshot drops it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.api.types import PathResult
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.obs import registry as obs_registry
from repro_torch.obs import trace as obs_trace
from repro_torch.resilience.inject import InjectedFault, take_load_failure, take_swap_failure
from repro_torch.resilience.retry import retry_call


@dataclass(frozen=True)
class StoreSnapshot:
    """An immutable view of one published path version: ``betas`` the
    device ``(L, p_pad)`` stack (the feature axis zero-padded to the
    store's alignment), ``lambdas`` on the host for resolving requested
    lambdas. A batch resolves its lambdas and scores against one
    snapshot."""

    version: int
    lambdas: np.ndarray          # (L,) descending, host
    betas: torch.Tensor          # (L, p_pad) on the store's device
    p: int                       # original feature count (before padding)

    @property
    def num_points(self) -> int:
        return int(self.lambdas.shape[0])

    @property
    def p_pad(self) -> int:
        return int(self.betas.shape[1])

    def index_of(self, lam: float) -> int:
        """Nearest stored lambda in log space (the grid is geometric)."""
        lams = np.maximum(np.asarray(self.lambdas, np.float64), 1e-300)
        return int(np.argmin(np.abs(np.log(lams) - np.log(max(lam, 1e-300)))))

    def indices_of(self, lams) -> np.ndarray:
        """:meth:`index_of` for a batch of requested lambdas (int32)."""
        grid = np.log(np.maximum(np.asarray(self.lambdas, np.float64), 1e-300))
        q = np.log(np.maximum(np.asarray(lams, np.float64), 1e-300))
        return np.argmin(np.abs(grid[None, :] - q[:, None]), axis=1).astype(np.int32)


class PathStore:
    """Holds the certified path on a device, versioned.

    ``mesh=None`` keeps the stack on ``device`` (default ``"cuda"``,
    raising without a card); with a (1, M) ``launch.mesh.DevMesh`` the
    stack lives on the mesh's device with its feature axis padded to
    ``M * tile``, the slab partition of ``ShardedDesign``'s residency, so
    that served scores are bit-identical to
    ``LogisticL1.decision_function`` through the same mesh."""

    def __init__(self, result: Optional[PathResult] = None, *, mesh=None,
                 tile: int = 128, device=DEFAULT_DEVICE):
        self.mesh = mesh
        self.tile = tile
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self._snap: Optional[StoreSnapshot] = None
        self._prev: Optional[StoreSnapshot] = None   # last-good fallback
        self._version = 0
        self.quarantined: list = []   # versions rolled back by quarantine()
        if result is not None:
            self.swap(result)

    # -- geometry -----------------------------------------------------------

    @property
    def pad_p_to(self) -> int:
        """Feature-axis alignment: ``M * tile`` on a mesh, else 1."""
        if self.mesh is None:
            return 1
        return self.mesh.shape["model"] * self.tile

    @property
    def snapshot(self) -> StoreSnapshot:
        if self._snap is None:
            raise ValueError("PathStore is empty -- swap() a PathResult in")
        return self._snap

    @property
    def version(self) -> int:
        return self._version

    # -- publish ------------------------------------------------------------

    def swap(self, result: PathResult, *, attempts: int = 3) -> StoreSnapshot:
        """Publish a new path version: the new stack is built on the
        device before the snapshot reference flips (one assignment,
        atomic under the GIL), so concurrent scorers only see complete
        versions. Transient build failures (``RuntimeError``: a device
        allocation) are retried with backoff; the store keeps serving the
        current snapshot meanwhile. Validation errors are not retried."""
        if len(result) == 0:
            raise ValueError("cannot publish an empty path")
        p = int(result.betas.shape[1])
        snap = self._snap
        if snap is not None and p != snap.p:
            raise ValueError(
                f"new path has p={p} but the store serves p={snap.p} -- "
                f"a feature-space change needs a new store")
        return retry_call(lambda: self._publish(result, p), attempts=attempts,
                          base_delay_s=0.01)

    def _publish(self, result: PathResult, p: int) -> StoreSnapshot:
        """One build-then-flip attempt (the retried unit of :meth:`swap`).
        The ``swap(points=)`` span closes at the stream synchronisation
        that completes the stack before the flip: tracing adds no sync."""
        with obs_trace.span("swap", points=len(result)):
            if take_swap_failure():
                raise InjectedFault("injected PathStore.swap failure")
            src = torch.as_tensor(result.betas, dtype=torch.float32)
            # a stack of the store's own, padded to the alignment
            betas = torch.zeros(src.shape[0], p + (-p) % self.pad_p_to,
                                dtype=torch.float32, device=self.device)
            betas[:, :p].copy_(src)
            if self.device.type == "cuda":
                # complete before publishing: scorers may run on other streams
                torch.cuda.current_stream(self.device).synchronize()
            self._version += 1
            new = StoreSnapshot(version=self._version,
                                lambdas=np.asarray(result.lambdas, np.float64),
                                betas=betas, p=p)
            self._prev = self._snap   # last-good, for quarantine()
            self._snap = new          # the publish
        obs_registry.counter("serve.swaps").inc()
        return new

    # -- rollback -----------------------------------------------------------

    def quarantine(self, version: int) -> bool:
        """Pin the store back to the previous snapshot if ``version`` is
        the one published (the scorer's non-finite guard calls this).
        Returns whether a rollback happened: False when ``version`` is
        already superseded or no previous snapshot is left."""
        if (self._snap is not None and self._snap.version == version
                and self._prev is not None):
            self._snap = self._prev
            self._prev = None         # no ping-pong back to the bad one
            self.quarantined.append(version)
            return True
        return False

    # -- persistence --------------------------------------------------------

    @classmethod
    def from_checkpoint(cls, directory: str, *, mesh=None, tile: int = 128,
                        device=DEFAULT_DEVICE, attempts: int = 3) -> "PathStore":
        """Fit once, serve many: load a ``PathResult.save`` checkpoint
        (either package's) and publish it. The load is retried with
        backoff (transient filesystem errors and injected faults); a
        checkpoint that stays corrupt raises ``RetriesExhausted`` with the
        ``CheckpointCorruption`` chained."""
        dev = mesh.device if mesh is not None else resolve_device(device)

        def load() -> PathResult:
            if take_load_failure():
                raise InjectedFault("injected checkpoint-load failure")
            return PathResult.load(directory, device=dev)

        result = retry_call(load, attempts=attempts, base_delay_s=0.01)
        return cls(result, mesh=mesh, tile=tile, device=dev)
