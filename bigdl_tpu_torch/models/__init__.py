"""Model builders of the port (counterpart of bigdl_tpu.models)."""
from bigdl_tpu_torch.models.resnet import (ResNet, ResNet50, fold_stem_to_s2d,
                                           unfold_stem_from_s2d)

__all__ = ["ResNet", "ResNet50", "fold_stem_to_s2d", "unfold_stem_from_s2d"]
