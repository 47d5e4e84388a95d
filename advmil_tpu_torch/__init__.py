"""PyTorch / CUDA port of advmil_tpu: the ESAT test-mode path on the GPU."""
