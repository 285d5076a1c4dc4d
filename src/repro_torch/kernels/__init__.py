# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Kernel layer of the port (counterpart of ``repro.kernels``): hand-written
Hopper kernels, their plain PyTorch versions (``ref``), and the dispatch
(``ops``).

The package re-exports the reference's ops (``repro/kernels/__init__.py``),
so ``repro_torch.kernels.gram_cd`` is the op, as ``repro.kernels.gram_cd``
is. Five ops share their name with the kernel module behind them
(``flash_attention``, ``gram_cd``, ``logistic_stats``, ``slab_gram``,
``slab_spmv``): the package attribute is the op, and the module is
``importlib.import_module("repro_torch.kernels.<name>")`` (or
``sys.modules``), which ``from repro_torch.kernels.<name> import ...``
also reaches. Loading ``ops`` here loads every kernel module first, so no
later import rebinds a name to its module."""
from repro_torch.kernels.ops import (flash_attention, gram_cd, logistic_stats,  # noqa: F401
                                     prefer_slab_gram, slab_corr, slab_gram, slab_spmv)

__all__ = ["flash_attention", "gram_cd", "logistic_stats", "prefer_slab_gram", "slab_corr",
           "slab_gram", "slab_spmv"]
