# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""The port's front door (counterpart of ``repro.api``): one estimator
(fit, the screened path, scoring) and one design per data layout (dense,
by-feature slabs, nnz-bucketed slabs, and any of them on a (1, M)
mesh)."""
from repro_torch.api.convert import (from_reference, lm_params_from_reference,
                                     path_from_reference)
from repro_torch.api.design import (BucketedSlabDesign, DenseDesign, Design, ShardedDesign,
                                    SlabDesign, as_design)
from repro_torch.api.estimator import LogisticL1, lambda_max_design, make_design_eval
from repro_torch.api.strategy import Strategy, resolve
from repro_torch.api.types import PathPoint, PathResult

__all__ = ["BucketedSlabDesign", "DenseDesign", "Design", "LogisticL1", "PathPoint", "PathResult",
           "ShardedDesign", "SlabDesign", "Strategy", "as_design", "from_reference",
           "lambda_max_design", "lm_params_from_reference", "make_design_eval",
           "path_from_reference", "resolve"]
