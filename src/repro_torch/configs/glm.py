# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""The paper's own workload: synthetic twins of the three Pascal Large
Scale Learning Challenge datasets (paper Table 2), as in
``repro/configs/glm.py``."""
from dataclasses import replace

from repro_torch.configs.base import GLMConfig

# dataset         size   #examples(train/test)  #features   nnz      avg nnz
# epsilon         12 Gb  0.4e6 / 0.1e6          2000        8.0e8    2000 (dense)
# webspam         21 Gb  0.315e6 / 0.035e6      16.6e6      1.2e9    3727
# dna             71 Gb  45e6 / 5e6             800         9.0e9    200
GLM_EPSILON = GLMConfig(
    name="glm-epsilon",
    citation="Trofimov & Genkin 2014, Table 2 (epsilon, Pascal LSLC 2008)",
    num_examples=400_000,
    num_features=2000,
    avg_nnz_per_example=2000,
    density=1.0,
)

GLM_WEBSPAM = GLMConfig(
    name="glm-webspam",
    citation="Trofimov & Genkin 2014, Table 2 (webspam)",
    num_examples=315_000,
    num_features=16_600_000,
    avg_nnz_per_example=3727,
    density=3727 / 16_600_000,
)

GLM_DNA = GLMConfig(
    name="glm-dna",
    citation="Trofimov & Genkin 2014, Table 2 (dna)",
    num_examples=45_000_000,
    num_features=800,
    avg_nnz_per_example=200,
    density=0.25,
)

GLM_CONFIGS = {c.name: c for c in (GLM_EPSILON, GLM_WEBSPAM, GLM_DNA)}


def twin(cfg: GLMConfig, scale: float = 0.01) -> GLMConfig:
    """Reduced synthetic twin preserving aspect/density."""
    n = max(1024, int(cfg.num_examples * scale))
    p = max(64, min(cfg.num_features, int(cfg.num_features * max(scale, 1e-3))))
    return replace(cfg, name=cfg.name + "-twin", num_examples=n, num_features=p)
