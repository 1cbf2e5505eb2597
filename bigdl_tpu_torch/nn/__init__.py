"""Layers of the port (counterpart of bigdl_tpu.nn): NHWC activations,
HWIO conv weights, ``(in, out)`` Linear weights, JAX child keys."""
from bigdl_tpu_torch.nn.activation import ReLU
from bigdl_tpu_torch.nn.beam_search import SequenceBeamSearch
from bigdl_tpu_torch.nn.attention import (FeedForwardNetwork,
                                          MultiHeadAttention, PositionEncode,
                                          Transformer, TransformerLayer)
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.criterion import (
    AbsCriterion, BCECriterion, BCEWithLogitsCriterion,
    CategoricalCrossEntropy, ClassNLLCriterion, ClassSimplexCriterion,
    CosineDistanceCriterion, CosineEmbeddingCriterion,
    CosineProximityCriterion, Criterion, CriterionAdapter,
    CrossEntropyCriterion, DiceCoefficientCriterion, DistKLDivCriterion,
    DotProductCriterion, GaussianCriterion, HingeEmbeddingCriterion,
    KLDCriterion, KullbackLeiblerDivergenceCriterion, L1Cost,
    L1HingeEmbeddingCriterion, MSECriterion, MarginCriterion,
    MarginRankingCriterion, MeanAbsolutePercentageCriterion,
    MeanSquaredLogarithmicCriterion, MultiCriterion,
    MultiLabelMarginCriterion, MultiLabelSoftMarginCriterion,
    MultiMarginCriterion, PGCriterion, ParallelCriterion, PoissonCriterion,
    SigmoidBinaryCrossEntropy, SmoothL1Criterion,
    SmoothL1CriterionWithWeights, SoftMarginCriterion,
    SoftmaxWithCriterion, TimeDistributedCriterion,
    TimeDistributedMaskCriterion, TransformerCriterion)
from bigdl_tpu_torch.nn.dropout import Dropout
from bigdl_tpu_torch.nn.embedding import LookupTable
from bigdl_tpu_torch.nn.fused_block import (FusedBasicBlock, FusedBottleneck,
                                            use_plain_ops)
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
    "AbsCriterion", "BCECriterion", "BCEWithLogitsCriterion",
    "BatchNormalization", "CAddTable", "CategoricalCrossEntropy",
    "ClassNLLCriterion", "ClassSimplexCriterion", "Container",
    "CosineDistanceCriterion", "CosineEmbeddingCriterion",
    "CosineProximityCriterion", "Criterion", "CriterionAdapter",
    "CrossEntropyCriterion", "DiceCoefficientCriterion",
    "DistKLDivCriterion", "DotProductCriterion", "Dropout",
    "FeedForwardNetwork", "FusedBasicBlock", "FusedBottleneck",
    "GaussianCriterion", "GlobalAveragePooling2D", "Graph",
    "HingeEmbeddingCriterion", "Input", "KLDCriterion",
    "KullbackLeiblerDivergenceCriterion", "L1Cost",
    "L1HingeEmbeddingCriterion", "LayerNormalization", "Linear",
    "LookupTable", "MSECriterion", "MarginCriterion",
    "MarginRankingCriterion", "MeanAbsolutePercentageCriterion",
    "MeanSquaredLogarithmicCriterion", "Module", "MsraFiller",
    "MultiCriterion", "MultiHeadAttention", "MultiLabelMarginCriterion",
    "MultiLabelSoftMarginCriterion", "MultiMarginCriterion", "Node",
    "PGCriterion", "ParallelCriterion", "PoissonCriterion",
    "PositionEncode", "QuantizedLinear", "QuantizedSpatialConvolution",
    "RandomNormal", "RandomUniform", "ReLU", "SequenceBeamSearch",
    "Sequential", "SigmoidBinaryCrossEntropy", "SmoothL1Criterion",
    "SmoothL1CriterionWithWeights", "SoftMarginCriterion",
    "SoftmaxWithCriterion", "SpaceToDepth", "SpatialBatchNormalization",
    "SpatialConvolution", "SpatialMaxPooling", "TimeDistributedCriterion",
    "TimeDistributedMaskCriterion", "Transformer", "TransformerCriterion",
    "TransformerLayer", "Xavier", "Zeros", "load_quantized", "quantize",
    "quantize_weight", "save_quantized", "split_rng", "use_plain_ops",
]
