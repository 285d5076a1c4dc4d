"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package ``repro``;
importing the whole port pulls in neither JAX nor Triton (Triton is
imported where a kernel launches); and an entry point asked for the card
on a host without one raises instead of running on the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
CHECKED = PORT_FILES + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0], node.lineno


def test_port_files_exist():
    assert len(PORT_FILES) >= 20
    assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "gram_cd.cu").exists()


def test_the_walk_covers_obs_and_resilience():
    """The stdlib-only copies of ``repro.obs`` and ``repro.resilience``
    are the likeliest to import the reference by habit: the AST walk
    must check each of them (and the chaos launcher)."""
    checked = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in PORT_FILES}
    for name in ("obs/__init__.py", "obs/registry.py", "obs/trace.py", "obs/export.py",
                 "obs/report.py", "resilience/__init__.py", "resilience/inject.py",
                 "resilience/progress.py", "resilience/retry.py", "launch/chaos_glm.py"):
        assert name in checked, name


@pytest.mark.parametrize("path", CHECKED, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_reference(path):
    bad = [(root, line) for root, line in _imported_roots(path) if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_triton():
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PORT_FILES)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in ('jax', 'triton', 'repro') if m in sys.modules]\n"
            "assert not bad, bad\n"
            "import torch\n"
            "assert torch.get_float32_matmul_precision() == 'highest'\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert not torch.backends.cudnn.allow_tf32\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.parametrize("entry", ["estimator", "dataset", "from_reference", "fit",
                                   "chaos_glm"])
def test_entry_points_raise_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch.api import LogisticL1, from_reference
    from repro_torch.configs.base import GLMConfig
    from repro_torch.core.dglmnet import fit
    from repro_torch.data.synthetic import make_glm_dataset
    from repro_torch.launch import chaos_glm

    X = np.zeros((8, 4), np.float32)
    y = np.ones(8, np.float32)
    call = {
        "estimator": lambda: LogisticL1().fit(X, y, 0.1),
        "dataset": lambda: make_glm_dataset(GLMConfig(num_examples=8, num_features=4),
                                            np.random.default_rng(0)),
        "from_reference": lambda: from_reference(np.zeros(4), 0.1),
        "fit": lambda: fit(X, y, 0.1),
        "chaos_glm": lambda: chaos_glm.main(["--smoke"]),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


EXAMPLE = ROOT / "examples" / "torch_quickstart.py"


def test_the_walk_covers_analysis_and_the_example():
    """The port's lint and sanitizers copy the reference's semantics and
    are the likeliest to import ``repro.analysis`` by habit; the port's
    quickstart sits outside the package. Both are checked, and importing
    the lint loads neither JAX nor the reference."""
    checked = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in PORT_FILES}
    for name in ("analysis/__init__.py", "analysis/__main__.py", "analysis/context.py",
                 "analysis/findings.py", "analysis/runner.py", "analysis/sanitize.py",
                 "analysis/rules/__init__.py", "analysis/rules/host_sync.py",
                 "analysis/rules/metric_discipline.py", "analysis/rules/bench_timing.py",
                 "analysis/rules/kernel_plain.py"):
        assert name in checked, name
    bad = [(root, line) for root, line in _imported_roots(EXAMPLE) if root in FORBIDDEN]
    assert not bad, f"examples/torch_quickstart.py imports {bad}"
    code = ("import sys, repro_torch.analysis, repro_torch.analysis.sanitize\n"
            "import repro_torch.analysis.rules\n"
            "bad = [m for m in ('jax', 'repro') if m in sys.modules]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_the_walk_covers_the_paper_slice():
    """The truncated-gradient baseline, the probe and the paper's drivers
    copy reference modules that import JAX; each is walked, and importing
    them loads neither JAX nor the reference."""
    checked = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in PORT_FILES}
    for name in ("core/truncated_gradient.py", "core/probe.py", "kernels/tg_pass.py",
                 "paper/__init__.py", "paper/__main__.py", "paper/common.py",
                 "paper/table2_datasets.py", "paper/table3_timing.py",
                 "paper/fig1_quality_sparsity.py", "paper/ablation_parallel_cd.py"):
        assert name in checked, name
    code = ("import sys, repro_torch.core.truncated_gradient, repro_torch.core.probe\n"
            "import repro_torch.paper.__main__, repro_torch.paper.fig1_quality_sparsity\n"
            "bad = [m for m in ('jax', 'triton', 'repro') if m in sys.modules]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.parametrize("entry", ["truncated_gradient_fit", "fit_python_loop",
                                   "train_sparse_probe", "paper"])
def test_paper_entry_points_raise_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch.core import fit_python_loop, truncated_gradient_fit
    from repro_torch.core.probe import train_sparse_probe
    from repro_torch.paper.__main__ import main

    X = np.zeros((8, 4), np.float32)
    y = np.ones(8, np.float32)
    call = {
        "truncated_gradient_fit": lambda: truncated_gradient_fit(X, y, 0.1),
        "fit_python_loop": lambda: fit_python_loop(X, y, 0.1),
        "train_sparse_probe": lambda: train_sparse_probe(X, y, lam=0.1),
        "paper": lambda: main(["--only", "table2", "--scale", "tiny"]),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
