"""Model builders of the port (counterpart of bigdl_tpu.models)."""
from bigdl_tpu_torch.models.autoencoder import Autoencoder
from bigdl_tpu_torch.models.lenet import LeNet5, lenet_graph
from bigdl_tpu_torch.models.resnet import (ResNet, ResNet50, fold_stem_to_s2d,
                                           fuse_resnet_params,
                                           unfold_stem_from_s2d,
                                           unfuse_resnet_params)

__all__ = ["Autoencoder", "LeNet5", "ResNet", "ResNet50", "fold_stem_to_s2d",
           "fuse_resnet_params", "lenet_graph", "unfold_stem_from_s2d",
           "unfuse_resnet_params"]
