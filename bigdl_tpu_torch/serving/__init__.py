"""Serving of the port (counterpart of bigdl_tpu.serving)."""
from bigdl_tpu_torch.serving.bucketing import Bucket, BucketGrid
from bigdl_tpu_torch.serving.engine import (DeadlineExceededError,
                                            EngineClosedError,
                                            QueueFullError, ServingEngine,
                                            ServingError, ServingFuture)
from bigdl_tpu_torch.serving.metrics import ServingMetrics
from bigdl_tpu_torch.serving.warmup import build_forward

__all__ = ["Bucket", "BucketGrid", "DeadlineExceededError",
           "EngineClosedError", "QueueFullError", "ServingEngine",
           "ServingError", "ServingFuture", "ServingMetrics",
           "build_forward"]
