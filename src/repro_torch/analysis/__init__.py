# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""repro_torch.analysis -- the port's lint and run-time sanitizers, the
counterpart of ``repro.analysis`` (the port imports nothing of it).

Static side (``python -m repro_torch.analysis src/repro_torch
chip_smoke.py``): four AST rules on the port's own conventions, each
id starting with ``torch-`` so that the two lints never take each
other's pragmas (``repro_torch.analysis.rules``):

* ``torch-host-sync`` -- device reads outside the engine's counted doors;
* ``torch-metric-discipline`` -- wall clocks and counter dicts outside
  ``repro_torch.obs``;
* ``torch-bench-timing`` -- a clock pair around CUDA work with no
  synchronisation between;
* ``torch-kernel-plain`` -- a kernel without its plain version, or a
  dispatch that reaches the plain version on the card.

Run-time side (``repro_torch.analysis.sanitize``): ``transfer_sanitizer``
holds a solve or a path to its counted host reads, ``compile_sanitizer``
to zero kernel builds on warm code.
"""
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.runner import Report, run_analysis

__all__ = ["Finding", "Report", "run_analysis"]
