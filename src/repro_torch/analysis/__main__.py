# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
import sys

from repro_torch.analysis.runner import main

if __name__ == "__main__":
    sys.exit(main())
