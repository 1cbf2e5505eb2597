"""Datasets of the port (counterpart of bigdl_tpu.dataset)."""
from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, DataSet,
                                             LocalArrayDataSet)
from bigdl_tpu_torch.dataset.minibatch import MiniBatch

__all__ = ["AbstractDataSet", "DataSet", "LocalArrayDataSet", "MiniBatch"]
