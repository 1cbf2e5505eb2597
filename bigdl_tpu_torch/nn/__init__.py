"""Layers of the port (counterpart of bigdl_tpu.nn): NHWC activations,
HWIO conv weights, ``(in, out)`` Linear weights, JAX child keys."""
from bigdl_tpu_torch.nn.activation import ReLU
from bigdl_tpu_torch.nn.attention import (FeedForwardNetwork,
                                          MultiHeadAttention, PositionEncode,
                                          Transformer, TransformerLayer)
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion, Criterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.dropout import Dropout
from bigdl_tpu_torch.nn.embedding import LookupTable
from bigdl_tpu_torch.nn.fused_block import FusedBottleneck, use_plain_ops
from bigdl_tpu_torch.nn.graph import Graph, Input, Node
from bigdl_tpu_torch.nn.init import (MsraFiller, RandomNormal, RandomUniform,
                                     Xavier, Zeros)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import (Container, Module, Sequential,
                                       split_rng)
from bigdl_tpu_torch.nn.norm import (BatchNormalization, LayerNormalization,
                                     SpatialBatchNormalization)
from bigdl_tpu_torch.nn.pool import GlobalAveragePooling2D, SpatialMaxPooling
from bigdl_tpu_torch.nn.quantized import (QuantizedLinear,
                                          QuantizedSpatialConvolution,
                                          load_quantized, quantize,
                                          quantize_weight, save_quantized)
from bigdl_tpu_torch.nn.reshape import SpaceToDepth
from bigdl_tpu_torch.nn.table_ops import CAddTable

__all__ = [
    "BatchNormalization", "CAddTable", "ClassNLLCriterion",
    "Container", "Criterion", "Dropout", "FeedForwardNetwork",
    "FusedBottleneck", "GlobalAveragePooling2D", "Graph", "Input",
    "LayerNormalization", "Linear", "LookupTable", "Module", "MsraFiller",
    "MultiHeadAttention", "Node", "PositionEncode", "QuantizedLinear",
    "QuantizedSpatialConvolution", "RandomNormal", "RandomUniform", "ReLU",
    "Sequential", "SpaceToDepth", "SpatialBatchNormalization",
    "SpatialConvolution", "SpatialMaxPooling", "TimeDistributedCriterion",
    "Transformer", "TransformerLayer", "Xavier", "Zeros", "load_quantized",
    "quantize", "quantize_weight", "save_quantized", "split_rng",
    "use_plain_ops",
]
