"""Kernels of the port and their plain PyTorch versions.

The flash-attention kernel's functions live in
:mod:`bigdl_tpu_torch.ops.flash_attention` (not re-exported here, where
the function of that name would hide the module)."""
from bigdl_tpu_torch.ops.attention import dot_product_attention
from bigdl_tpu_torch.ops.fused_matmul import (
    LAUNCHES, bn_constants, conv3x3_wgrad, fused_conv3x3_bn,
    fused_conv3x3_bn_dgrad, fused_conv3x3_bn_dgrad_plain,
    fused_conv3x3_bn_plain, fused_matmul_bn, fused_matmul_bn_dgrad,
    fused_matmul_bn_dgrad_plain, fused_matmul_bn_plain,
    fused_matmul_bn_wgrad, fused_matmul_bn_wgrad_plain, reset_launches)

__all__ = ["LAUNCHES", "bn_constants", "conv3x3_wgrad",
           "dot_product_attention", "fused_conv3x3_bn",
           "fused_conv3x3_bn_dgrad", "fused_conv3x3_bn_dgrad_plain",
           "fused_conv3x3_bn_plain", "fused_matmul_bn",
           "fused_matmul_bn_dgrad", "fused_matmul_bn_dgrad_plain",
           "fused_matmul_bn_plain", "fused_matmul_bn_wgrad",
           "fused_matmul_bn_wgrad_plain", "reset_launches"]
