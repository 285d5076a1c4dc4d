# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Collection of pieces held by the ranks of a mesh axis, the counterpart
of ``repro/sharding/collect.py``.

The reference reshards a P(model) vector to replicated before it
concatenates (``jax.device_put`` to P()). On a ``launch.mesh.ProcMesh``
each rank holds its own piece, and the whole vector is one
``all_reduce(SUM)`` of the pieces zero-padded to the whole length
(:func:`merge_exact`): every position gets one piece's value and zeros
from every other rank, summed as integers (a float as its bit pattern),
so every rank receives the pieces' own bits, a -0.0 included. On a
``DevMesh`` (and along an axis of one rank) the piece is the whole.

The other direction, blocks that one rank owns built from pieces that
other ranks hold (the screened path's restricted design on a design split
over ``model``), is :func:`route`: one :func:`merge_exact` per
destination, kept by the destination alone, so a rank never holds more
than its own block and the one in flight.

This module is the one home of that collection; call sites do not pad
and reduce by hand.
"""
from __future__ import annotations

import torch


def replicate(piece: torch.Tensor, mesh, *, start: int, size: int,
              axis="model") -> torch.Tensor:
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
    return merge_exact(full, mesh, axis=axis)


def concat_replicated(piece: torch.Tensor, mesh, *, axis="model") -> torch.Tensor:
    """The pieces of every rank along ``axis`` (each rank passes its own,
    all of one shape) concatenated in rank order along dim 0, on every
    rank of the axis."""
    ranks = mesh.axis_ranks(axis)
    n = piece.shape[0]
    return replicate(piece, mesh, start=mesh.axis_index(axis) * n, size=ranks * n, axis=axis)


def merge_exact(part: torch.Tensor, mesh, *, axis="model") -> torch.Tensor:
    """The sum over the ranks of ``axis`` of parts in which every position
    is nonzero on at most one rank, bit for bit, on every rank: a float32
    part is summed as its int32 bit patterns (a -0.0 or a NaN arrives as
    its holder wrote it), an integer part as itself (integer sums are
    exact). On an axis of one rank the part itself."""
    if mesh.axis_ranks(axis) == 1:
        return part
    if part.dtype == torch.float32:
        return mesh.all_reduce(part.view(torch.int32), axis).view(torch.float32)
    return mesh.all_reduce(part, axis)


def route(part_for, mesh, *, axis="model") -> torch.Tensor:
    """This rank's block, when each rank of ``axis`` owns one block built
    from pieces that the ranks hold: ``part_for(j)`` is this rank's share
    of rank j's block, zero where it holds none of it (see
    :func:`merge_exact`). One merge per destination rank, in rank order,
    each kept by its destination alone. On an axis of one rank
    ``part_for(0)``."""
    ranks = mesh.axis_ranks(axis)
    if ranks == 1:
        return part_for(0)
    mine = None
    for j in range(ranks):
        block = merge_exact(part_for(j), mesh, axis=axis)
        if j == mesh.axis_index(axis):
            mine = block
    return mine
