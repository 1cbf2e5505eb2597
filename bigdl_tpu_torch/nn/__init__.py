"""Layers of the port (counterpart of bigdl_tpu.nn): NHWC activations,
HWIO conv weights, ``(in, out)`` Linear weights, JAX child keys."""
from bigdl_tpu_torch.nn.activation import ReLU
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion, Criterion
from bigdl_tpu_torch.nn.fused_block import FusedBottleneck, use_plain_ops
from bigdl_tpu_torch.nn.graph import Graph, Input, Node
from bigdl_tpu_torch.nn.init import MsraFiller, RandomUniform, Zeros
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Container, Module, Sequential
from bigdl_tpu_torch.nn.norm import (BatchNormalization,
                                     SpatialBatchNormalization)
from bigdl_tpu_torch.nn.pool import GlobalAveragePooling2D, SpatialMaxPooling
from bigdl_tpu_torch.nn.reshape import SpaceToDepth
from bigdl_tpu_torch.nn.table_ops import CAddTable

__all__ = [
    "BatchNormalization", "CAddTable", "ClassNLLCriterion", "Container",
    "Criterion", "FusedBottleneck",
    "GlobalAveragePooling2D", "Graph", "Input", "Linear", "Module",
    "MsraFiller", "Node", "RandomUniform", "ReLU",
    "Sequential", "SpaceToDepth", "SpatialBatchNormalization",
    "SpatialConvolution", "SpatialMaxPooling", "Zeros", "use_plain_ops",
]
