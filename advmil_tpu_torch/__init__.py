"""PyTorch / CUDA port of advmil_tpu for one NVIDIA GPU (H100, sm_90a):
adversarial training and test mode of the cfg_nlst ESAT path (with its
patch-embedding options, the fused embedding among them) and of PatchGCN,
over hand-written CUDA kernels for every Pallas kernel of the JAX package."""
