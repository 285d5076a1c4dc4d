"""Quickstart for the PyTorch port: L1-regularized logistic regression
through the one front door (``repro_torch.api.LogisticL1`` over a
``Design``), with the path solve traced through ``repro_torch.obs`` (a
per-lambda phase report at the end). The port's counterpart of
``examples/quickstart.py``, on the same 8192 x 256 problem.

    PYTHONPATH=src python examples/torch_quickstart.py                # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu   # plain versions
"""
import argparse

import numpy as np

from repro_torch.api import DenseDesign, LogisticL1, SlabDesign, lambda_max_design
from repro_torch.configs.base import GLMConfig
from repro_torch.core.dglmnet import DGLMNETOptions
from repro_torch.data.synthetic import make_glm_dataset
from repro_torch.device import resolve_device
from repro_torch.obs import observe, render_summary
from repro_torch.train.metrics import glm_eval_fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = GLMConfig(name="quickstart", num_examples=8192, num_features=256, density=1.0)
    ds = make_glm_dataset(cfg, np.random.default_rng(0), device=dev)
    design = DenseDesign(ds.X_train)
    y = ds.y_train
    lmax = float(lambda_max_design(design, y))
    n, p = design.shape
    print(f"n={n}  p={p}  lambda_max={lmax:.2f}  device={dev}")

    # single solve, simulating 8 machines (feature blocks)
    est = LogisticL1(DGLMNETOptions(num_blocks=8, method="gram", tile=32), device=dev)
    res = est.fit(design, y, lmax / 64, verbose=True)
    print(f"\nfit: status={res.status_name}  f={res.f:.4f}  nnz={res.nnz}/{p}"
          f"  iters={res.n_iters}  unit-step={res.unit_step_frac:.0%}")

    # the same solve from the by-feature slab layout: one front door, any
    # Design; the strategy resolver picks the execution
    res_slab = est.fit(SlabDesign.from_dense(ds.X_train), y, lmax / 64)
    print(f"slab layout: f={res_slab.f:.4f} (same solve, different Design)")

    # regularization path (paper Algorithm 5) with test metrics, traced:
    # observe() arms repro_torch.obs for the block, so the driver's spans
    # (screen rounds, restricted solves, KKT checks) land in a summary
    print("\nregularization path:")
    est = LogisticL1(DGLMNETOptions(num_blocks=8, tile=32), device=dev)
    with observe() as obs:
        pts = est.path(design, y, path_len=8,
                       eval_fn=glm_eval_fn(ds.X_test.cpu().numpy(), ds.y_test.cpu().numpy()),
                       verbose=True)
    best = max(pts, key=lambda pt: pt.metrics["auprc"])
    print(f"\nbest: lambda={best.lam:.3f} nnz={best.nnz} AUPRC={best.metrics['auprc']:.4f}")

    # score through the estimator (margins through the Design)
    proba = est.predict_proba(DenseDesign(ds.X_test), beta=best.beta)
    print(f"test P(y=+1) range: [{float(proba.min()):.3f}, {float(proba.max()):.3f}]")

    # where did the path spend its time? (the report
    # `python -m repro_torch.obs.report <file>` gives for an exported summary)
    print("\nobservability -- per-phase path report:")
    print(render_summary(obs.summary()))


if __name__ == "__main__":
    main()
