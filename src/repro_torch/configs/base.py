# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""GLM problem configuration (counterpart of ``repro/configs/base.py``
``GLMConfig``; the LM configurations are not ported yet)."""
from __future__ import annotations

from dataclasses import dataclass, replace

GLM = "glm"


@dataclass(frozen=True)
class GLMConfig:
    """The paper's own problem: L1-regularized logistic regression.

    A synthetic twin of each Table-2 dataset; dims match the paper.
    """

    name: str = "glm"
    arch_type: str = GLM
    citation: str = "Trofimov & Genkin 2014, Table 2"
    num_examples: int = 0
    num_features: int = 0
    avg_nnz_per_example: int = 0     # density hint for synthetic twin
    density: float = 1.0             # fraction of nonzero entries
    lam_path_len: int = 20           # Algorithm 5: lambda_max * 2^{-i}

    # tiling for the Gram-CD solver
    feature_tile: int = 256

    def smoke(self) -> "GLMConfig":
        return replace(self, name=self.name + "-smoke",
                       num_examples=min(self.num_examples, 2048),
                       num_features=min(self.num_features, 128),
                       lam_path_len=4, feature_tile=32)
