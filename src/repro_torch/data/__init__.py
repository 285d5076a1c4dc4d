# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Data generation for the port (counterpart of ``repro.data``)."""
