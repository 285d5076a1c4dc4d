#!/bin/bash
# Build and run scripts/tg_step_probe.cu on a machine with an H100 (see its
# header); prints the card's name and power limit before and after.
set -e
cd "$(dirname "$0")/.."
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
mkdir -p build
"${CUDA_HOME:-/usr/local/cuda}/bin/nvcc" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
    -o build/tg_step_probe scripts/tg_step_probe.cu
build/tg_step_probe
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
