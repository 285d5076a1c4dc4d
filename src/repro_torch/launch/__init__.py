# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Launch helpers of the port (counterpart of ``repro.launch``): the mesh
description only, so far."""
