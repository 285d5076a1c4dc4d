# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Figure 1: test quality (AUPRC) against the number of nonzeros -- the
d-GLMNET regularization path against distributed online learning via
truncated gradient, the best over a VW-style sweep with every pass's
snapshot evaluated (paper section 4.3). The counterpart of
``benchmarks/fig1_quality_sparsity.py``, with its grids: a 10-point path
(16 blocks of tile 64, at most 50 iterations), TG learning rates 0.1, 0.3
and 0.5 over 8 passes at lambda_max / 16, / 64 and / 256. Both systems
are scored by one device-side eval (``common.make_device_eval``)."""
from __future__ import annotations

import torch

from repro_torch.paper.common import SCALES, Timer, emit, load_twin, make_device_eval

PATH_LEN = 10
PATH_OPTS = dict(num_blocks=16, tile=64, max_iters=50)
TG_LRS = (0.1, 0.3, 0.5)
TG_PASSES = 8
TG_LAM_DIVS = (16, 64, 256)


def run_dataset(name: str, X, y, X_test, y_test, device="cuda", verbose: bool = True):
    """Figure 1's rows of one dataset: (dataset, system, lambda, nnz,
    auprc), and a summary dict with both sides' best AUPRC, the path's
    points and the TG snapshots' nnz by (lambda divisor, learning rate)."""
    from repro_torch.core import engine
    from repro_torch.core.dglmnet import DGLMNETOptions
    from repro_torch.core.objective import lambda_max
    from repro_torch.core.regpath import regularization_path
    from repro_torch.core.truncated_gradient import TGOptions, truncated_gradient_fit
    from repro_torch.device import resolve_device

    eval_fn = make_device_eval(X_test, y_test)
    rows = []
    with Timer(device) as t_d:
        pts = regularization_path(X, y, path_len=PATH_LEN, opts=DGLMNETOptions(**PATH_OPTS),
                                  eval_fn=eval_fn, device=device)
    for p in pts:
        rows.append((name, "d-glmnet", f"{p.lam:.4g}", p.nnz, p.metrics["auprc"]))

    tg_nnz, tg_finite = {}, True
    with Timer(device) as t_tg:
        lmax = engine.host_read(lambda_max(X, y))
        for lam_div in TG_LAM_DIVS:
            for lr in TG_LRS:
                snaps = truncated_gradient_fit(
                    X, y, lmax / lam_div,
                    opts=TGOptions(num_machines=16, passes=TG_PASSES, learning_rate=lr),
                    generator=torch.Generator(device=resolve_device(device)).manual_seed(0),
                    device=device)
                for pass_idx, beta in snaps:
                    mt = eval_fn(beta)
                    tg_finite &= mt["finite"]
                    tg_nnz[(lam_div, lr, pass_idx)] = mt["nnz"]
                    rows.append((name, f"tg(lr={lr})", f"{lmax / lam_div:.4g}@p{pass_idx}",
                                 mt["nnz"], mt["auprc"]))

    best_d = max(r[4] for r in rows if r[1] == "d-glmnet")
    best_t = max(r[4] for r in rows if r[1].startswith("tg"))
    wins = best_d >= best_t - 0.02
    emit(f"fig1.{name}.dglmnet_path", t_d.dt * 1e6 / PATH_LEN, f"best_auprc={best_d:.4f}")
    emit(f"fig1.{name}.tg_sweep", t_tg.dt * 1e6 / (len(TG_LAM_DIVS) * len(TG_LRS) * TG_PASSES),
         f"best_auprc={best_t:.4f};dglmnet_wins={wins}")
    if verbose:
        print(f"# {name}: d-GLMNET best AUPRC {best_d:.4f} vs TG best {best_t:.4f}")
    return rows, {"best_dglmnet": best_d, "best_tg": best_t, "dglmnet_wins": wins,
                  "path": pts, "tg_nnz": tg_nnz, "tg_finite": tg_finite,
                  "path_s": t_d.dt, "tg_s": t_tg.dt}


def run(scale: str = "twin", device="cuda", verbose: bool = True):
    rows = []
    for name in SCALES[scale]:
        ds = load_twin(name, scale=scale, device=device)
        rows += run_dataset(name, ds.X_train, ds.y_train, ds.X_test, ds.y_test, device,
                            verbose)[0]
    return rows
