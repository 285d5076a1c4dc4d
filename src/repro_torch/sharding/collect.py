# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Collection of pieces held by the ranks of a mesh axis, the counterpart
of ``repro/sharding/collect.py``.

The reference reshards a P(model) vector to replicated before it
concatenates (``jax.device_put`` to P()). On a ``launch.mesh.ProcMesh``
each rank holds its own piece, and the whole vector is one
``all_reduce(SUM)`` of the pieces zero-padded to the whole length: every
position gets one piece's value and zeros from every other rank, and
adding zeros is exact, so every rank receives the pieces' own bits. On a
``DevMesh`` (and along an axis of one rank) the piece is the whole.

This module is the one home of that collection; call sites do not pad
and reduce by hand.
"""
from __future__ import annotations

import torch


def replicate(piece: torch.Tensor, mesh, *, start: int, size: int,
              axis: str = "model") -> torch.Tensor:
    """The (size, ...) tensor whose rows ``[start, start + len(piece))``
    are this rank's ``piece``, the rest from the other ranks of ``axis``,
    on every rank of it. The ranks' pieces must not overlap. On an axis
    of one rank ``piece`` must be the whole (start 0, length ``size``)."""
    if mesh.axis_ranks(axis) == 1:
        if start != 0 or piece.shape[0] != size:
            raise ValueError(f"one rank holds the whole axis: piece rows [{start}, "
                             f"{start + piece.shape[0]}) of {size}")
        return piece
    full = piece.new_zeros((size, *piece.shape[1:]))
    full[start:start + piece.shape[0]] = piece
    return mesh.all_reduce(full, axis)


def concat_replicated(piece: torch.Tensor, mesh, *, axis: str = "model") -> torch.Tensor:
    """The pieces of every rank along ``axis`` (each rank passes its own,
    all of one shape) concatenated in rank order along dim 0, on every
    rank of the axis."""
    ranks = mesh.axis_ranks(axis)
    index = mesh.data_rank if axis == "data" else mesh.model_rank
    n = piece.shape[0]
    return replicate(piece, mesh, start=index * n, size=ranks * n, axis=axis)
