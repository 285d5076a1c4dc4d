# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""The paper's tables and figure on the port (counterparts of the
reference's ``benchmarks/{table2_datasets,table3_timing,
fig1_quality_sparsity,ablation_parallel_cd}.py``):

    python -m repro_torch.paper [--only table2|table3|fig1|ablation]
        [--scale twin|tiny] [--device cpu]
"""
