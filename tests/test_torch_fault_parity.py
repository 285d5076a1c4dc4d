"""The port's reactions to injected faults against the reference's, on the
CPU, under the same ``FaultPlan`` (``repro_torch.resilience`` and
``repro.resilience``) and the same numpy problem (256 x 64 at density
0.1, the reference's tiny size):

* the path's degradation ladder: an engine fault in the margins at the
  first iteration of a solve, transient (``engine_fires=1``: the first
  solve of the path) and persistent (every solve), in both cycle modes,
  on a local dense design and a slab design on a (1, 1) mesh; and two
  fires in the blocked mode, which the ``"sequential"`` rung absorbs.
  Per point the same status and the same ``degraded`` / ``skipped``
  labels, and the same number of solves consulted (``faults.engine`` on
  each package's registry: one consult per solve);
* a transient lost bucket on a streamed slab path: the same residency
  counters (hits, misses, evictions, puts, retries, bytes moved) and
  ``retry.retries`` in both packages.

The reference runs on ``make_dev_mesh(1, 1)``: no fake-device process.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro.resilience as jres
from repro.api import LogisticL1 as JLogisticL1
from repro.api import ShardedDesign as JShardedDesign
from repro.api import SlabDesign as JSlabDesign
from repro.api import as_design as j_as_design
from repro.core.dglmnet import DGLMNETOptions as JOptions
from repro.data import byfeature as jbf
from repro.launch.mesh import make_dev_mesh as j_make_dev_mesh
from repro_torch.api import LogisticL1, ShardedDesign, SlabDesign, as_design
from repro_torch.configs.base import GLMConfig
from repro_torch.core.dglmnet import DGLMNETOptions
from repro_torch.data.byfeature import to_by_feature, to_slab_buckets, to_slabs
from repro_torch.data.synthetic import make_glm_dataset
from repro_torch.launch import chaos_glm
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.obs import observe
from repro_torch.resilience import EngineFault, FaultPlan, inject_faults

torch.set_num_threads(2)
TILE = 16


@pytest.fixture(scope="module")
def tiny():
    ds = make_glm_dataset(GLMConfig(name="resilience", num_examples=256, num_features=64,
                                    density=0.1),
                          np.random.default_rng(0), device="cpu")
    X, y = ds.X_train.numpy(), ds.y_train.numpy()
    rows, vals, _ = to_slabs(to_by_feature(X), 1)
    return dict(X=X, y=y, rows=rows.numpy(), vals=vals.numpy())


def _paths(tiny, layout, mode, fires, path_len):
    """The same path under the same plan in both packages: (port, ref,
    port consults, ref consults)."""
    n = len(tiny["y"])
    fault = dict(kind="margins", at_iter=1)
    if layout == "dense":
        port_est = LogisticL1(DGLMNETOptions(cycle_mode=mode), device="cpu")
        ref_est = JLogisticL1(opts=JOptions(cycle_mode=mode))
        port_in, ref_in, kw = tiny["X"], jnp.asarray(tiny["X"]), {}
    else:
        opts = dict(cycle_mode=mode, tile=TILE, block=4)
        port_est = LogisticL1(DGLMNETOptions(**opts), device="cpu")
        ref_est = JLogisticL1(opts=JOptions(**opts))
        port_in = ShardedDesign(SlabDesign(torch.from_numpy(tiny["rows"]),
                                           torch.from_numpy(tiny["vals"]), n),
                                make_dev_mesh(1, 1, device="cpu"), tile=TILE)
        ref_in = JShardedDesign(JSlabDesign(jnp.asarray(tiny["rows"]),
                                            jnp.asarray(tiny["vals"]), n),
                                j_make_dev_mesh(1, 1), tile=TILE)
        kw = dict(densify=False)
    with observe() as obs, inject_faults(FaultPlan(engine=EngineFault(**fault),
                                                   engine_fires=fires)):
        port = port_est.path(port_in, tiny["y"], path_len=path_len, **kw)
    with jobs.observe() as jobs_session, jres.inject_faults(jres.FaultPlan(
            engine=jres.EngineFault(**fault), engine_fires=fires)):
        ref = ref_est.path(ref_in, jnp.asarray(tiny["y"]), path_len=path_len, **kw)
    return (port, ref, obs.registry.value("faults.engine"),
            jobs_session.registry.value("faults.engine"))


def _labels(res):
    return [(s.get("degraded"), s.get("skipped")) for s in res.screen]


@pytest.mark.parametrize("layout", ["dense", "mesh-slab"])
@pytest.mark.parametrize("mode", ["sequential", "blocked"])
@pytest.mark.parametrize("fires", [1, None], ids=["transient", "persistent"])
def test_degradation_labels_match_reference(tiny, layout, mode, fires):
    path_len = 3 if fires == 1 else 2
    port, ref, port_consults, ref_consults = _paths(tiny, layout, mode, fires, path_len)
    assert np.array_equal(port.statuses, np.asarray(ref.statuses))
    assert _labels(port) == _labels(ref)
    assert port_consults == ref_consults
    if fires == 1:
        # the first solve of the path tripped; the rewarm ran clean
        assert port.all_ok and _labels(port)[0] == ("rewarm", None)
        assert port_consults == 1
    else:
        assert not port.all_ok and all(lab == ("skipped", True) for lab in _labels(port))
        assert bool(torch.isfinite(port.betas).all()) and np.all(port.n_iters == 0)
        # a point's solve, its rewarm and, in the blocked mode, the
        # sequential rung: every rung of the ladder was tried
        assert port_consults == path_len * (3 if mode == "blocked" else 2)


def test_two_fires_reach_the_sequential_rung(tiny):
    port, ref, port_consults, ref_consults = _paths(tiny, "dense", "blocked", 2, 2)
    assert _labels(port) == _labels(ref)
    assert _labels(port)[0] == ("sequential", None) and port.all_ok
    assert port_consults == ref_consults == 2


def test_transient_lost_bucket_counts_match_reference():
    args = type("A", (), {"n": 128, "p": 64})()
    X, y = chaos_glm.mixed_density_dataset(args)
    port_slabs = to_slab_buckets(to_by_feature(X), 1)
    ref_slabs = jbf.to_slab_buckets(jbf.to_by_feature(X), 1)
    mesh, jmesh = make_dev_mesh(1, 1, device="cpu"), j_make_dev_mesh(1, 1)
    sizing = as_design(port_slabs, mesh=mesh, tile=TILE)
    budget = sizing.slab_nbytes(TILE) - min(sizing.slab_bucket_nbytes(TILE))
    opts = dict(tile=TILE, max_iters=40, device_budget_bytes=budget)
    port_des = as_design(port_slabs, mesh=mesh, tile=TILE, device_budget_bytes=budget)
    ref_des = j_as_design(ref_slabs, mesh=jmesh, tile=TILE, device_budget_bytes=budget)
    with observe() as obs, inject_faults(FaultPlan(fail_prefetches=2)):
        port = LogisticL1(DGLMNETOptions(**opts), mesh=mesh, device="cpu").path(
            port_des, y, path_len=3)
    with jobs.observe() as jsession, jres.inject_faults(jres.FaultPlan(fail_prefetches=2)):
        ref = JLogisticL1(opts=JOptions(**opts), mesh=jmesh).path(
            ref_des, jnp.asarray(y), path_len=3)
    ps, rs = port_des.residency_stats()[TILE], ref_des.residency_stats()[TILE]
    for key in ("hits", "misses", "evictions", "puts", "retries", "bytes_h2d", "n_buckets"):
        assert ps[key] == rs[key], (key, ps, rs)
    assert ps["retries"] == 2
    assert obs.registry.value("retry.retries") == jsession.registry.value("retry.retries") == 2
    assert np.array_equal(port.nnz, ref.nnz)
    np.testing.assert_allclose(port.f, ref.f, rtol=1e-4)
