# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Launchers of the port (counterpart of ``repro.launch``): the mesh
description and the LM serving and training launchers (``python -m
repro_torch.launch.serve``, ``python -m repro_torch.launch.train``)."""
