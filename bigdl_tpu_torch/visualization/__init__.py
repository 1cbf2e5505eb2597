"""Training visualization (counterpart of bigdl_tpu.visualization):
TensorBoard event files written with a hand-written protobuf encoder and
the masked CRC32C framing, with no TensorFlow."""
from bigdl_tpu_torch.visualization.summary import (ServingSummary, Summary,
                                                   TelemetrySummary,
                                                   TrainSummary,
                                                   ValidationSummary,
                                                   subsample_tree)
from bigdl_tpu_torch.visualization.tensorboard import (FileWriter, crc32c,
                                                       read_events)

__all__ = ["FileWriter", "ServingSummary", "Summary", "TelemetrySummary",
           "TrainSummary", "ValidationSummary", "crc32c", "read_events",
           "subsample_tree"]
