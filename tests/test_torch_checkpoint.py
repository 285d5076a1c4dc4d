"""The port's checkpointer (``repro_torch.checkpoint``) and
``PathResult.save`` / ``load`` against the reference's
(``repro.checkpoint``, ``repro.api.PathResult``), on the CPU:

* the port writes and the reference reads, and the reverse; arrays,
  step and meta equal, and the files byte for byte the reference's;
* truncation, a flipped bit and a missing manifest raise
  ``CheckpointCorruption`` (damaged with the reference's own
  ``corrupt_checkpoint``); a manifest without ``crc32`` still loads;
* concurrent writers never tear a checkpoint silently;
* a ``PathResult`` saved by either package loads in the other.
"""
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as jck
from repro.api import LogisticL1 as JLogisticL1
from repro.api import PathResult as JPathResult
from repro.resilience import corrupt_checkpoint
from repro_torch.api import LogisticL1, PathResult
from repro_torch.checkpoint import (CheckpointCorruption, load_pytree, read_meta, save_pytree,
                                    verify_payload)
from repro_torch.core.dglmnet import DGLMNETOptions

torch.set_num_threads(2)
META = {"kind": "test", "lams": [0.5, 0.25], "note": "x"}


def _tree(xp, scale=1.0):
    """The same tree in numpy-backed torch or jax arrays: nested dict keys
    out of order, float32 and int32 leaves."""
    a = np.arange(8, dtype=np.float32) * scale
    c = np.ones((2, 3), np.float32) * scale
    d = np.array([3, 1, 2], np.int32)
    return {"z": xp(a), "b": {"d": xp(d), "c": xp(c)}}


def _port_tree(scale=1.0):
    return _tree(torch.from_numpy, scale)


def _ref_tree(scale=1.0):
    return _tree(jnp.asarray, scale)


def _assert_tree_equal(got, want):
    np.testing.assert_array_equal(np.asarray(got["z"]), np.asarray(want["z"]))
    np.testing.assert_array_equal(np.asarray(got["b"]["c"]), np.asarray(want["b"]["c"]))
    np.testing.assert_array_equal(np.asarray(got["b"]["d"]), np.asarray(want["b"]["d"]))


def test_port_and_reference_read_each_other(tmp_path):
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    save_pytree(_port_tree(), mine, step=7, meta=META)
    jck.save_pytree(_ref_tree(), theirs, step=7, meta=META)
    for name in ("arrays.npz", "manifest.json"):
        with open(os.path.join(mine, name), "rb") as a, open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(mine, "manifest.json")) as fh:
        paths = [leaf["path"] for leaf in json.load(fh)["leaves"]]
    assert paths == ["['b']['c']", "['b']['d']", "['z']"]
    out = jck.load_pytree(mine, _ref_tree(0.0))
    _assert_tree_equal(out, _port_tree())
    back = load_pytree(theirs, _port_tree(0.0))
    _assert_tree_equal(back, _port_tree())
    assert back["b"]["d"].dtype == torch.int32 and back["z"].dtype == torch.float32
    assert jck.read_meta(mine) == read_meta(theirs) == META
    assert verify_payload(theirs) is True and jck.verify_payload(mine) is True


@pytest.mark.parametrize("mode", ["truncate", "bitflip", "missing-manifest"])
def test_damaged_checkpoints_raise(tmp_path, mode):
    d = str(tmp_path / "ck")
    save_pytree(_port_tree(), d, step=1)
    if mode == "missing-manifest":
        os.remove(os.path.join(d, "manifest.json"))
        with pytest.raises(CheckpointCorruption, match="missing manifest"):
            read_meta(d)
    else:
        corrupt_checkpoint(d, mode, seed=5)
    with pytest.raises(CheckpointCorruption):
        verify_payload(d)
    with pytest.raises(CheckpointCorruption):
        load_pytree(d, _port_tree(0.0))


def test_manifest_without_crc_still_loads(tmp_path):
    d = str(tmp_path / "ck")
    save_pytree(_port_tree(), d)
    mpath = os.path.join(d, "manifest.json")
    with open(mpath) as fh:
        man = json.load(fh)
    man.pop("crc32"), man.pop("payload_bytes")
    with open(mpath, "w") as fh:
        json.dump(man, fh)
    assert verify_payload(d) is False            # unverifiable, not corrupt
    _assert_tree_equal(load_pytree(d, _port_tree(0.0)), _port_tree())
    with pytest.raises(ValueError, match="shape mismatch"):
        load_pytree(d, {"z": torch.zeros(9), "b": {"c": torch.zeros(2, 3),
                                                   "d": torch.zeros(3, dtype=torch.int32)}})


def test_concurrent_writers_never_tear(tmp_path):
    """Each rename publishes one writer's complete bytes, so the directory
    either loads as exactly one writer's tree or (a manifest paired with
    another writer's payload) raises ``CheckpointCorruption``."""
    d = str(tmp_path / "ck")
    barrier = threading.Barrier(4)
    errors = []

    def write(i):
        try:
            barrier.wait(timeout=30)
            for _ in range(5):
                save_pytree(_port_tree(float(i)), d, step=i)
        except Exception as e:  # pragma: no cover - the failure path
            errors.append(e)

    threads = [threading.Thread(target=write, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors
    try:
        out = load_pytree(d, _port_tree(0.0))
    except CheckpointCorruption:
        return                                   # a torn pair: detected, not loaded
    winner = float(out["z"][1])
    assert winner in {0.0, 1.0, 2.0, 3.0}
    _assert_tree_equal(out, _port_tree(winner))


def test_path_result_crosses_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    X = ((rng.random((96, 40)) < 0.2) * rng.normal(size=(96, 40))).astype(np.float32)
    y = np.where(rng.random(96) < 0.5, 1.0, -1.0).astype(np.float32)
    ref = JLogisticL1().path(X, y, path_len=4)
    port = LogisticL1(DGLMNETOptions(), device="cpu").path(X, y, path_len=4)
    # the reference's checkpoint serves from the port, and the reverse
    got = PathResult.load(ref.save(str(tmp_path / "ref")), device="cpu")
    back = JPathResult.load(port.save(str(tmp_path / "port")))
    again = PathResult.load(str(tmp_path / "port"), device="cpu")
    for a, b in ((got, ref), (port, back), (again, port)):
        np.testing.assert_array_equal(np.asarray(a.betas), np.asarray(b.betas))
        np.testing.assert_array_equal(a.lambdas, b.lambdas)
        np.testing.assert_array_equal(a.nnz, b.nnz)
        np.testing.assert_array_equal(a.f, b.f)
        np.testing.assert_array_equal(a.statuses, b.statuses)
        assert a.screen == b.screen and a.metrics == b.metrics
    assert got.betas.dtype == torch.float32 and got.betas.device.type == "cpu"
    with pytest.raises(ValueError, match="not a PathResult checkpoint"):
        save_pytree({"betas": torch.zeros(2, 3)}, str(tmp_path / "plain"))
        PathResult.load(str(tmp_path / "plain"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PathResult.load(str(tmp_path / "port"))
