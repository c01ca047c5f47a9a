"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each with
its plain PyTorch version; the twin of ``svdsolver_tpu/ops/pallas``."""
