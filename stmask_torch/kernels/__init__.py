"""Hand-written CUDA kernels of the port (sm_90a), each beside its plain
PyTorch version.  Nothing is built or loaded at import time.

Importing the package registers the custom ops ``stmask::correlate``,
``stmask::deform_conv`` and ``stmask::greedy_nms_keep`` (the kernel on
CUDA tensors, the plain version on CPU tensors, and a fake implementation
for ``torch.export``), which an exported program calls."""

from . import (correlation, correlation_bwd, deform_col2im, deform_conv,
               deform_im2col, deform_wgrad, greedy_nms)

# name -> CudaKernel, for launch counts (the bf16 variants are kernels of
# the same libraries, counted apart)
KERNELS = {'correlation': correlation.KERNEL,
           'correlation_bf16': correlation.KERNEL_BF16,
           'deform_im2col': deform_im2col.KERNEL,
           'deform_conv': deform_conv.KERNEL,
           'deform_conv_bf16': deform_conv.KERNEL_BF16,
           'deform_conv_bf16_f32off': deform_conv.KERNEL_BF16_F32OFF,
           'correlation_bwd': correlation_bwd.KERNEL,
           'deform_col2im': deform_col2im.KERNEL,
           'deform_wgrad': deform_wgrad.KERNEL,
           'greedy_nms': greedy_nms.KERNEL}
