# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Dependency-free tree checkpointer, the port's copy of
``repro/checkpoint/checkpointer.py``, writing and reading the same files:

    <dir>/manifest.json  (leaf paths, dtypes and shapes, step, meta, and
                          the payload's size and CRC-32)
    <dir>/arrays.npz     (the leaves, keyed leaf_0, leaf_1, ...)

A tree is nested dicts (keys in sorted order), lists and tuples whose
leaves are tensors or arrays; each leaf's path is written as
``jax.tree_util.keystr`` writes it (``{"betas": x}`` gives
``['betas']``), so a checkpoint written by one package loads in the
other.

Durability: both files are written to a same-directory temporary name
and ``os.replace``d into place (atomic on POSIX), the payload first and
the manifest last, so the manifest is the commit marker. The manifest's
``payload_bytes`` and ``crc32`` are checked before any array is read;
a mismatch (bit flip, truncation, a torn pair) raises
:class:`CheckpointCorruption`. Manifests without ``crc32`` still load,
unverified.
"""
from __future__ import annotations

import io
import itertools
import json
import os
import threading
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

_PAYLOAD = "arrays.npz"
_MANIFEST = "manifest.json"


class CheckpointCorruption(RuntimeError):
    """The checkpoint on disk fails its integrity contract (CRC or size
    mismatch, unreadable payload, missing files). Callers that keep a
    last-good checkpoint should catch this and roll back to it."""


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in the reference's flattening order: dict keys
    sorted, sequences by index; paths as ``keystr`` renders them."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _flatten(tree[key], f"{prefix}[{key!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, sub in enumerate(tree):
            out += _flatten(sub, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in flattening order."""
    if isinstance(like, dict):
        return {key: _unflatten(like[key], leaves) for key in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(sub, leaves) for sub in like)
    return next(leaves)


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a host array and the dtype name the manifest records
    (bfloat16 is stored as float32, as the reference stores it)."""
    if not torch.is_tensor(leaf):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().numpy(), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


_tmp_seq = itertools.count()


def _write_atomic(path: str, data: bytes) -> None:
    """Same-directory temporary write + ``os.replace`` (atomic on POSIX).
    The temporary name is unique per process, thread and call, so
    concurrent writers never tear each other's staging file."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}.{next(_tmp_seq)}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_pytree(tree: Any, directory: str, *, step: Optional[int] = None,
                meta: Optional[dict] = None) -> str:
    """Write ``tree`` to ``directory``; ``meta`` is an optional
    JSON-serialisable side channel stored in the manifest (read back by
    :func:`read_meta`)."""
    os.makedirs(directory, exist_ok=True)
    arrays = {}
    manifest = {"leaves": [], "step": step}
    if meta is not None:
        manifest["meta"] = meta
    for name, leaf in _flatten(tree):
        arr, dtype_name = _host_array(leaf)
        key = f"leaf_{len(arrays)}"
        arrays[key] = arr
        manifest["leaves"].append(
            {"path": name, "key": key, "dtype": dtype_name, "shape": list(arr.shape)})
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    manifest["payload_bytes"] = len(payload)
    manifest["crc32"] = zlib.crc32(payload)
    # payload first, manifest last: the manifest's rename is the commit
    _write_atomic(os.path.join(directory, _PAYLOAD), payload)
    _write_atomic(os.path.join(directory, _MANIFEST),
                  json.dumps(manifest, indent=1).encode())
    return directory


def _read_manifest(directory: str) -> dict:
    path = os.path.join(directory, _MANIFEST)
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise CheckpointCorruption(f"missing manifest: {path}")
    except json.JSONDecodeError as err:
        raise CheckpointCorruption(f"unreadable manifest {path}: {err}")


def verify_payload(directory: str) -> bool:
    """Re-hash the payload against the manifest's CRC-32. Returns True when
    verified, False when the manifest has no CRC (nothing to check).
    Raises :class:`CheckpointCorruption` on a size or CRC mismatch or a
    missing payload."""
    manifest = _read_manifest(directory)
    if "crc32" not in manifest:
        return False
    path = os.path.join(directory, _PAYLOAD)
    try:
        with open(path, "rb") as f:
            payload = f.read()
    except FileNotFoundError:
        raise CheckpointCorruption(f"missing payload: {path}")
    if len(payload) != manifest.get("payload_bytes"):
        raise CheckpointCorruption(
            f"payload size mismatch in {directory}: {len(payload)} bytes on disk vs "
            f"{manifest.get('payload_bytes')} in manifest (truncated write?)")
    crc = zlib.crc32(payload)
    if crc != manifest["crc32"]:
        raise CheckpointCorruption(
            f"payload CRC mismatch in {directory}: {crc:#010x} on disk vs "
            f"{manifest['crc32']:#010x} in manifest")
    return True


def read_meta(directory: str) -> Optional[dict]:
    """The ``meta`` dict stored by :func:`save_pytree`, or None."""
    return _read_manifest(directory).get("meta")


def load_pytree(directory: str, like: Any, *, device=None) -> Any:
    """Restore into the structure of ``like`` (paths and shapes must
    match; its leaves are tensors), each leaf a tensor of its ``like``
    leaf's dtype, on ``device``
    (default: the CPU). The payload is verified first: a damaged
    checkpoint raises :class:`CheckpointCorruption` before any array is
    read."""
    manifest = _read_manifest(directory)
    verify_payload(directory)
    try:
        data = np.load(os.path.join(directory, _PAYLOAD))
        by_path = {e["path"]: data[e["key"]] for e in manifest["leaves"]}
    except (OSError, ValueError, KeyError) as err:
        raise CheckpointCorruption(f"unreadable payload in {directory}: {err}")
    leaves = []
    for name, leaf in _flatten(like):
        if name not in by_path:
            raise KeyError(f"checkpoint missing leaf {name}")
        arr = by_path[name]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch at {name}: {arr.shape} vs {tuple(leaf.shape)}")
        leaves.append(torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=device or "cpu", dtype=leaf.dtype))
    return _unflatten(like, iter(leaves))
