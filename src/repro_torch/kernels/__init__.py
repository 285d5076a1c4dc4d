# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Kernel layer of the port (counterpart of ``repro.kernels``): hand-written
Hopper kernels, their plain PyTorch versions (``ref``), and the dispatch
(``ops``)."""
