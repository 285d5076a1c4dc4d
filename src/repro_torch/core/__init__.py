# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Solver core of the port (counterpart of ``repro.core``).

Re-exports the reference's ``repro.core`` names that the port has, so a
script written against ``from repro.core import ...`` has a port name to
move to. The names resolve on first use (PEP 562): the kernel dispatch
imports ``core.subproblem`` and the engine imports the dispatch, so an
eager import here would close a cycle. Not ported yet: ``fit_distributed``,
``make_dglmnet_step`` and ``make_dglmnet_step_sparse`` (multi-GPU)."""
from importlib import import_module

_EXPORTS = {
    "repro_torch.core.dglmnet": ("DGLMNETOptions", "FitResult", "FitState",
                                 "dglmnet_iteration", "fit", "fit_python_loop"),
    "repro_torch.core.distributed": ("DistributedFitResult", "fit_distributed_sparse"),
    "repro_torch.core.engine": ("SolverState", "make_solver", "make_step"),
    "repro_torch.core.linesearch": ("LineSearchResult", "line_search"),
    "repro_torch.core.objective": ("lambda_max", "margins", "neg_log_likelihood",
                                   "objective", "soft_threshold", "working_stats"),
    "repro_torch.api.types": ("PathPoint", "PathResult"),
    "repro_torch.core.regpath": ("regularization_path", "regularization_path_distributed"),
    "repro_torch.core.screening": ("kkt_violations", "nll_grad_abs_sparse",
                                   "strong_rule_mask"),
    "repro_torch.core.subproblem": ("blocked_cycle_modes", "cd_cycle_blocked_tile",
                                    "cd_cycle_gram", "cd_cycle_gram_tile",
                                    "cd_cycle_residual", "make_tile_solver",
                                    "solve_subproblem"),
    "repro_torch.core.truncated_gradient": ("TGOptions", "truncated_gradient_fit"),
}
_SOURCE = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = sorted(_SOURCE)


def __getattr__(name):
    mod = _SOURCE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(import_module(mod), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_SOURCE))
