# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Table 2: dataset summary of the synthetic twins (the counterpart of
``benchmarks/table2_datasets.py``); the paper-scale dimensions are
``configs/glm.py``'s."""
from __future__ import annotations

import torch

from repro_torch.configs.glm import GLM_CONFIGS
from repro_torch.paper.common import SCALES, Timer, emit, load_twin


def run(scale: str = "twin", device="cuda"):
    from repro_torch.core import engine

    rows = []
    print("# dataset,examples(train/test),features,nnz,avg_nnz/example")
    for name in SCALES[scale]:
        with Timer(device) as t:
            ds = load_twin(name, scale=scale, device=device)
        nnz = int(engine.host_read(torch.stack([(ds.X_train != 0).sum(),
                                                (ds.X_test != 0).sum()]).sum()))
        n_train, n_test = ds.X_train.shape[0], ds.X_test.shape[0]
        rows.append((name, f"{n_train}/{n_test}", ds.X_train.shape[1], nnz,
                     f"{nnz / (n_train + n_test):.1f}"))
        print("# " + ",".join(str(c) for c in rows[-1]))
        emit(f"table2.{name}.gen", t.dt * 1e6, f"nnz={nnz}")
    print("# paper-scale configs:")
    for c in GLM_CONFIGS.values():
        print(f"# {c.name}: n={c.num_examples} p={c.num_features} "
              f"avg_nnz={c.avg_nnz_per_example}")
    return rows
