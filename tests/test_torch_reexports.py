"""The port's subpackages re-export the reference's package-level names.

For each of ``kernels``, ``api``, ``train``, ``models`` and ``configs``,
every public name of the reference package (``dir()``, which includes
the names a package resolves lazily through its ``__dir__``) must be an
attribute of the port's package, except the names listed in
:data:`NOT_YET` with the module that brings them; those must still be
absent, so the list shrinks as they come. Submodules and ``__future__``
features are not exports. ``repro_torch.core`` has its own case in
``tests/test_torch_paper.py``.
"""
import __future__
import importlib
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SUBPACKAGES = ("kernels", "api", "train", "models", "configs")
#: reference names whose module the port does not have yet, by ROADMAP item
NOT_YET = {
    # configs/shapes.py: queue 1 item 5.11
    "configs": {"SHAPES", "InputShape", "get_shape"},
}


def _exports(mod):
    return sorted(name for name in dir(mod) if not name.startswith("_")
                  and not isinstance(getattr(mod, name, None),
                                     (types.ModuleType, __future__._Feature)))


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_reexports_every_reference_name(sub):
    ref = importlib.import_module(f"repro.{sub}")
    port = importlib.import_module(f"repro_torch.{sub}")
    missing = NOT_YET.get(sub, set())
    names = _exports(ref)
    assert names
    for name in names:
        if name in missing:
            assert not hasattr(port, name), f"{name} is ported: take it off NOT_YET"
            continue
        assert hasattr(port, name), f"repro.{sub}.{name} has no counterpart in repro_torch.{sub}"
        value = getattr(port, name)
        assert not isinstance(value, types.ModuleType), f"repro_torch.{sub}.{name} is a module"
        if callable(getattr(ref, name)):
            assert callable(value), f"repro_torch.{sub}.{name} is not callable"
    with pytest.raises(AttributeError):
        getattr(port, "not_a_reference_name")


def test_kernel_ops_stay_ops_after_their_modules_load():
    """Five ops share their name with their kernel module: the package
    attribute is the op before and after the module is imported, and the
    module stays reachable by ``import_module``."""
    from repro_torch.kernels import ops

    kernels = importlib.import_module("repro_torch.kernels")
    for name in ("flash_attention", "gram_cd", "logistic_stats", "slab_gram", "slab_spmv"):
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        assert isinstance(mod, types.ModuleType) and hasattr(mod, "launches")
        assert getattr(kernels, name) is getattr(ops, name)
    assert kernels.prefer_slab_gram is ops.prefer_slab_gram
    assert kernels.slab_corr is ops.slab_corr


def test_importing_train_and_configs_loads_no_lm_model():
    """As the reference's, ``repro_torch.train`` resolves the LM steps on
    first use: importing it (or the configs) does not load the model zoo."""
    code = ("import sys\n"
            "import repro_torch.train, repro_torch.configs\n"
            "from repro_torch.train import auprc, glm_eval_fn\n"
            "assert 'repro_torch.models.transformer' not in sys.modules\n"
            "import repro_torch.train.metrics\n"
            "assert 'repro_torch.optim' not in sys.modules\n"
            "from repro_torch.train import make_prefill_step\n"
            "assert 'repro_torch.models.transformer' in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stderr[-2000:]
