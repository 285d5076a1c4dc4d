"""The reference's API surfaces the port had no name for (ROADMAP queue 3),
on the CPU:

* ``repro_torch.api.Design``: a runtime-checkable protocol with the
  reference's members (``repro.api.Design``); every port design is an
  instance of it;
* ``ops.logistic_stats(m, y, block=)`` and ``ops.flash_attention(...,
  block_q=, block_k=)`` take the reference's keywords: a call written for
  the reference runs, gives results bit-equal to the default call for
  several block sizes (the keywords are TPU tile sizes that the Hopper
  kernels do not take), and a block that is not a positive int raises as
  the reference's kernels would refuse it.
"""
import inspect
import typing

import numpy as np
import pytest
import torch

import repro.api as japi
from repro.kernels import ops as j_ops
from repro_torch.api import (BucketedSlabDesign, DenseDesign, Design, ShardedDesign,
                             SlabDesign)
from repro_torch.data import byfeature as tbf
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_dev_mesh


def _members(proto):
    return set(typing._get_protocol_attrs(proto))


def test_design_protocol_has_the_reference_members():
    assert _members(Design) == _members(japi.Design) == {
        "layout", "shape", "margins", "correlation", "gram_tile", "gather", "scatter"}
    assert getattr(Design, "_is_runtime_protocol", False)
    for name in ("margins", "correlation", "gram_tile", "gather", "scatter"):
        assert (list(inspect.signature(getattr(Design, name)).parameters)
                == list(inspect.signature(getattr(japi.Design, name)).parameters)), name


def test_every_port_design_is_a_design():
    rng = np.random.default_rng(0)
    X = (rng.normal(size=(32, 16)) * (rng.random((32, 16)) < 0.4)).astype(np.float32)
    bf = tbf.to_by_feature(X)
    slab = SlabDesign.from_by_feature(bf)
    designs = [DenseDesign(torch.from_numpy(X)), slab,
               BucketedSlabDesign(tbf.to_slab_buckets(bf, 1), 32),
               ShardedDesign(slab, make_dev_mesh(1, 2, device="cpu"), tile=8)]
    for d in designs:
        assert isinstance(d, Design), type(d).__name__
    assert not isinstance(object(), Design)


@pytest.mark.parametrize("block", [1, 128, 4096, 65536])
def test_logistic_stats_takes_the_reference_block(block):
    rng = np.random.default_rng(block)
    m = torch.from_numpy(rng.normal(size=1000).astype(np.float32) * 3)
    y = torch.from_numpy(np.where(rng.random(1000) < 0.5, 1.0, -1.0).astype(np.float32))
    want = ops.logistic_stats(m, y)
    got = ops.logistic_stats(m, y, block=block)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert "block" in inspect.signature(j_ops.logistic_stats).parameters


@pytest.mark.parametrize("blocks", [(128, 128), (64, 128), (128, 32), (256, 256)])
def test_flash_attention_takes_the_reference_blocks(blocks):
    block_q, block_k = blocks
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 256, 4, 32, generator=g)
    k = torch.randn(1, 256, 2, 32, generator=g)
    v = torch.randn(1, 256, 2, 32, generator=g)
    want = ops.flash_attention(q, k, v, causal=True)
    got = ops.flash_attention(q, k, v, causal=True, block_q=block_q, block_k=block_k)
    assert torch.equal(got, want)
    params = inspect.signature(j_ops.flash_attention).parameters
    assert params["block_q"].default == params["block_k"].default == 128


@pytest.mark.parametrize("bad", [0, -128, 1.5, True, "128"])
def test_block_keywords_must_be_positive_ints(bad):
    t = torch.zeros(8)
    with pytest.raises(ValueError, match="positive int"):
        ops.logistic_stats(t, t, block=bad)
    q = torch.zeros(1, 128, 2, 16)
    with pytest.raises(ValueError, match="positive int"):
        ops.flash_attention(q, q, q, block_q=bad)
    with pytest.raises(ValueError, match="positive int"):
        ops.flash_attention(q, q, q, block_k=bad)
