"""Hand-written CUDA kernels of the port (sm_90a), each beside its plain
PyTorch version.  Nothing is built or loaded at import time.

Importing the package registers the custom ops ``stmask::correlate``,
``stmask::deform_conv``, ``stmask::greedy_nms_keep`` and
``stmask::greedy_nms_plus_one_keep`` (the kernel on CUDA tensors, the plain
version on CPU tensors, and a fake implementation for ``torch.export``),
which an exported program calls, and those of the training backward,
``stmask::correlation_bwd``, ``stmask::deform_wgrad``,
``stmask::deform_col2im`` and ``stmask::deform_exact_bwd`` (called with
autograd off, as a backward runs; ``utils/flops.py`` counts each op's
work whichever implementation runs)."""

from . import (correlation, correlation_bwd, deform_col2im, deform_conv,
               deform_exact_bwd, deform_im2col, deform_wgrad, greedy_nms)

# name -> CudaKernel, for launch counts (the bf16 variants are kernels of
# the same libraries, counted apart)
KERNELS = {'correlation': correlation.KERNEL,
           'correlation_bf16': correlation.KERNEL_BF16,
           'deform_im2col': deform_im2col.KERNEL,
           'deform_conv': deform_conv.KERNEL,
           'deform_conv_bf16': deform_conv.KERNEL_BF16,
           'deform_conv_bf16_f32off': deform_conv.KERNEL_BF16_F32OFF,
           'correlation_bwd': correlation_bwd.KERNEL,
           'correlation_bwd_bf16': correlation_bwd.KERNEL_BF16,
           'deform_col2im': deform_col2im.KERNEL,
           'deform_col2im_bf16': deform_col2im.KERNEL_BF16,
           'deform_col2im_bf16_f32off': deform_col2im.KERNEL_BF16_F32OFF,
           'deform_wgrad': deform_wgrad.KERNEL,
           'deform_wgrad_bf16': deform_wgrad.KERNEL_BF16,
           'deform_wgrad_bf16_f32off': deform_wgrad.KERNEL_BF16_F32OFF,
           'deform_exact_bwd': deform_exact_bwd.KERNEL,
           'deform_exact_bwd_bf16': deform_exact_bwd.KERNEL_BF16,
           'deform_exact_bwd_bf16_f32off':
               deform_exact_bwd.KERNEL_BF16_F32OFF,
           'greedy_nms': greedy_nms.KERNEL,
           'greedy_nms_boxes': greedy_nms.KERNEL_BOXES}
