"""The benchmark of the PyTorch/CUDA port: sparse SPD solves of the HPCG
problem on one card. See README.md."""
