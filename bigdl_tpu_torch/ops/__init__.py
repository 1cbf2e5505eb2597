"""Kernels of the port and their plain PyTorch versions.

The flash-attention kernel's functions live in
:mod:`bigdl_tpu_torch.ops.flash_attention` (not re-exported here, where
the function of that name would hide the module); the int8 kernel's
``LAUNCHES`` and ``reset_launches`` in
:mod:`bigdl_tpu_torch.ops.int8_matmul` for the same reason (the names
here are the fused kernels')."""
from bigdl_tpu_torch.ops.attention import dot_product_attention
from bigdl_tpu_torch.ops.fused_matmul import (
    LAUNCHES, bn_constants, conv3x3_wgrad, fused_conv3x3_bn,
    fused_conv3x3_bn_dgrad, fused_conv3x3_bn_dgrad_plain,
    fused_conv3x3_bn_plain, fused_matmul_bn, fused_matmul_bn_dgrad,
    fused_matmul_bn_dgrad_plain, fused_matmul_bn_plain,
    fused_matmul_bn_wgrad, fused_matmul_bn_wgrad_plain, reset_launches)
from bigdl_tpu_torch.ops.int8_matmul import (int8_matmul_dequant,
                                             int8_matmul_dequant_plain)

__all__ = ["LAUNCHES", "bn_constants", "conv3x3_wgrad",
           "dot_product_attention", "fused_conv3x3_bn",
           "fused_conv3x3_bn_dgrad", "fused_conv3x3_bn_dgrad_plain",
           "fused_conv3x3_bn_plain", "fused_matmul_bn",
           "fused_matmul_bn_dgrad", "fused_matmul_bn_dgrad_plain",
           "fused_matmul_bn_plain", "fused_matmul_bn_wgrad",
           "fused_matmul_bn_wgrad_plain", "int8_matmul_dequant",
           "int8_matmul_dequant_plain", "reset_launches"]
