"""legoslam_tpu_torch: the PyTorch + CUDA port of legoslam_tpu.

Same subpackage layout as the JAX reference (`geometry/ ops/ solver/
pipeline/ utils/`); every module is the twin of the reference module at the
same relative path.  The reference's Pallas kernels are hand-written CUDA
C++ for Hopper (`csrc/*.cu`), built with nvcc on first use and bound with
ctypes (`kernels/`); each sits beside its plain PyTorch version, which is
also the CPU path.

The pipeline is float32 end to end.  Matmuls and convolutions are pinned to
full float32 so a CUDA run computes what the CPU run computes (cuDNN would
otherwise run float32 convolutions in TF32).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
