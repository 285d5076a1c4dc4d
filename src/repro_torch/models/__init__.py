# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""The LM zoo of the port (counterpart of ``repro.models``): the dense
attention architectures (GQA, RoPE, RMSNorm, SwiGLU), the MoE layer
(``models/moe.py``: top-k routing with capacity, a shared expert, the
auxiliary losses) and the Mamba2 SSD block (``models/ssm.py``), for
training, prefill and decode. MLA, hybrid and enc-dec layers are not
ported yet."""
from repro_torch.models.params import (count_params_analytic, forward, init_cache, init_params,
                                       is_encdec, param_bytes)
from repro_torch.models.transformer import (init_lm_cache, init_lm_params, lm_forward,
                                            segments_of)

__all__ = ["count_params_analytic", "forward", "init_cache", "init_lm_cache", "init_lm_params",
           "init_params", "is_encdec", "lm_forward", "param_bytes", "segments_of"]
