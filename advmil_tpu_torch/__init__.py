"""PyTorch / CUDA port of advmil_tpu for one NVIDIA GPU (H100, sm_90a):
adversarial training and test mode of the cfg_nlst ESAT path (with its
patch-embedding options, the fused embedding among them) and of PatchGCN,
over hand-written CUDA kernels for every Pallas kernel of the JAX package."""
import torch

# On the CPU, torch's exp, log, tanh, sqrt, sin and cos (and a few others)
# run through MKL's vector math library, split into pieces of 2,048 values
# over OpenMP threads. When the first call of one of these functions in a
# process comes from several threads at once, some of the threads return
# values good to about 12 bits (exp: relative error 1.5e-4, where later calls
# are within one ulp): the plain versions of the kernels then miss their
# references now and then. One call of each function the port uses, on one
# thread, sets the library up first; this helps only where the package is
# imported before the process's first parallel call of that function.
for _fn in (torch.exp, torch.log, torch.tanh, torch.sqrt, torch.sin, torch.cos):
    _fn(torch.ones(1))
del _fn
