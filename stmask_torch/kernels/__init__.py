"""Hand-written CUDA kernels of the port (sm_90a), each beside its plain
PyTorch version.  Nothing is built or loaded at import time."""

from . import correlation, deform_conv, deform_im2col

# name -> CudaKernel, for launch counts
KERNELS = {'correlation': correlation.KERNEL,
           'deform_im2col': deform_im2col.KERNEL,
           'deform_conv': deform_conv.KERNEL}
