# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""The paper's tables on the port: prints ``name,us_per_call,derived``
rows (plus commented context lines), as ``benchmarks/run.py`` does.

    python -m repro_torch.paper [--only table2|table3|fig1|ablation]
        [--scale twin|tiny] [--device cuda|cpu]

Without ``--only``: Table 2, Table 3 and Figure 1; the ablation is
opt-in. ``--scale tiny`` cuts every twin so that the CPU runs each driver
in seconds. The default device is the card; ``--device cpu`` runs the
kernels' plain versions on the host."""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.paper")
    ap.add_argument("--only", default=None, choices=["table2", "table3", "fig1", "ablation"])
    ap.add_argument("--scale", default="twin", choices=["twin", "tiny"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    from repro_torch.paper import (ablation_parallel_cd, fig1_quality_sparsity,
                                   table2_datasets, table3_timing)

    resolve_device(args.device)
    print("name,us_per_call,derived")
    if args.only in (None, "table2"):
        table2_datasets.run(args.scale, args.device)
    if args.only in (None, "table3"):
        table3_timing.run(args.scale, args.device)
    if args.only in (None, "fig1"):
        fig1_quality_sparsity.run(args.scale, args.device)
    if args.only == "ablation":
        ablation_parallel_cd.run(args.scale, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
