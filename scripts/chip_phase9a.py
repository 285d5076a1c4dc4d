"""Phase 9a of ``chip_smoke.py`` (the process mesh) alone, on a narrower
webspam-shaped cell, from the root of a checkout on a machine with a card:

    python3 scripts/chip_phase9a.py [--p-log2 16]

Builds the kernels, fits the cell on a (1, 16) ``DevMesh`` (phase 7's
sequential fit), its first ``PM_PATH_LEN`` path points (phase 8's head) and the
epsilon cell's sequential fit (phase 4's), then runs
``chip_smoke.phase_process_mesh`` against them: about 1.5 minutes at
2^16 features, the machine's wait not counted."""
import argparse
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--p-log2", type=int, default=16, help="features of the cell: 2^this")
args = ap.parse_args()
if not torch.cuda.is_available():
    cs.fail("no CUDA device: this script runs phase 9a on the card")
t0 = time.perf_counter()
card = cs.phase_device(torch)
cs.phase_build(torch)
import repro_torch  # noqa: F401,E402
from repro_torch.api import DenseDesign, LogisticL1, SlabDesign, lambda_max_design
from repro_torch.configs.glm import GLM_EPSILON
from repro_torch.core.dglmnet import DGLMNETOptions
from repro_torch.core.objective import lambda_max
from repro_torch.data.synthetic import make_glm_dataset
from repro_torch.launch.mesh import make_dev_mesh

cell = cs.sparse_cell(torch, p=2 ** args.p_log2)
(rows, vals, y), _ = cell
n = y.shape[0]
lam = float(lambda_max_design(SlabDesign(rows, vals, n), y)) / 16
opts = DGLMNETOptions(cycle_mode="sequential", **cs.SPARSE_OPTS)
mesh = make_dev_mesh(1, 16)
LogisticL1(replace(opts, max_iters=1), mesh=mesh).fit(SlabDesign(rows, vals, n), y, lam)
res = LogisticL1(opts, mesh=mesh).fit(SlabDesign(rows, vals, n), y, lam)
path = LogisticL1(opts, mesh=mesh).path(SlabDesign(rows, vals, n), y, path_len=cs.PM_PATH_LEN)
print(f"[phase9a] DevMesh fit {res.n_iters} iters f {res.f}; path f {list(path.f)}")
gen = torch.Generator(device="cuda").manual_seed(0)
ds = make_glm_dataset(GLM_EPSILON, gen, device="cuda")
elam = float(lambda_max(ds.X_train, ds.y_train)) / 16
eopts = DGLMNETOptions(num_blocks=16, tile=128, max_iters=100, cycle_mode="sequential", block=16)
eres = LogisticL1(eopts).fit(DenseDesign(ds.X_train), ds.y_train, elam)
print(f"[phase9a] epsilon fit {eres.n_iters} iters f {eres.f}")
launches = cs.phase_process_mesh(torch, card, cell, (res.n_iters, res.f, res.beta,
                                                     res.objective_history),
                                 lam, GLM_EPSILON.num_examples, elam, eres.f, list(path.f))
print("PHASE 9A OK", launches, f"{time.perf_counter() - t0:.1f} s")
