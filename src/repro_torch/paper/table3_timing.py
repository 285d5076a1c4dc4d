# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Table 3: execution times -- iterations to convergence, time per
iteration, the line search's share; truncated gradient's time per pass
beside it (one iteration of either is one full pass over the data, paper
section 4.4). The counterpart of ``benchmarks/table3_timing.py``, with the
same options: lambda_max / 64, 16 blocks of tile 64, at most 40
iterations; TG on 16 machines, 4 passes timed after 1 warm pass."""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.paper.common import SCALES, Timer, emit, load_twin

DGLMNET = dict(num_blocks=16, tile=64, max_iters=40)
TG_MACHINES, TG_PASSES = 16, 4
LS_REPS = 5


def ls_ms(fn, device, reps: int = LS_REPS) -> float:
    """Milliseconds per call of ``fn``: CUDA events on the card, the
    synchronising :class:`Timer` on the host."""
    if resolve_device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    with Timer(device) as t:
        for _ in range(reps):
            fn()
    return t.dt * 1e3 / reps


def run_dataset(name: str, X, y, device="cuda") -> dict:
    """Table 3's row of one dataset (X, y the training set on ``device``)."""
    from repro_torch.core import engine
    from repro_torch.core.dglmnet import DGLMNETOptions, dglmnet_iteration, fit
    from repro_torch.core.linesearch import line_search
    from repro_torch.core.objective import lambda_max, margins
    from repro_torch.core.truncated_gradient import TGOptions, truncated_gradient_fit

    lam = engine.host_read(lambda_max(X, y)) / 64
    opts = DGLMNETOptions(**DGLMNET)
    fit(X, y, lam, opts=DGLMNETOptions(**dict(DGLMNET, max_iters=2)), device=device)  # warm-up
    with Timer(device) as t_fit:
        res = fit(X, y, lam, opts=opts, device=device)
    t_iter = t_fit.dt / max(res.n_iters, 1)

    # the line search's share: the line search alone from beta = 0
    beta0 = torch.zeros_like(res.beta)
    m0 = margins(X, beta0)
    dbeta, dm, gd = dglmnet_iteration(X, y, beta0, m0, lam, opts)
    t_ls = ls_ms(lambda: line_search(m0, dm, y, beta0, dbeta, lam, gd), device) / 1e3
    share = min(t_ls / max(t_iter, 1e-9), 1.0)
    del dbeta, dm

    truncated_gradient_fit(X, y, lam, opts=TGOptions(num_machines=TG_MACHINES, passes=1),
                           device=device)
    with Timer(device) as t_tg:
        truncated_gradient_fit(X, y, lam, opts=TGOptions(num_machines=TG_MACHINES,
                                                         passes=TG_PASSES), device=device)
    t_pass = t_tg.dt / TG_PASSES

    print(f"# {name},{res.n_iters},{t_iter * 1e6:.0f},{share:.2%},{t_pass * 1e6:.0f}")
    emit(f"table3.{name}.dglmnet_iter", t_iter * 1e6,
         f"iters={res.n_iters};ls_share={share:.3f}")
    emit(f"table3.{name}.tg_pass", t_pass * 1e6, "")
    return {"name": name, "iters": res.n_iters, "status": res.status_name, "lam": lam,
            "iter_ms": t_iter * 1e3, "ls_ms": t_ls * 1e3, "ls_share": share,
            "tg_pass_ms": t_pass * 1e3}


def run(scale: str = "twin", device="cuda"):
    print("# dataset,iters,time_per_iter_us,linesearch_share,tg_time_per_pass_us")
    rows = []
    for name in SCALES[scale]:
        ds = load_twin(name, scale=scale, device=device)
        rows.append(run_dataset(name, ds.X_train, ds.y_train, device))
    return rows
