"""Training of the port (counterpart of bigdl_tpu.optim)."""
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.optimizer import (LocalOptimizer, Optimizer,
                                             make_train_step)
from bigdl_tpu_torch.optim.schedules import Default, LearningRateSchedule
from bigdl_tpu_torch.optim.triggers import Trigger

__all__ = ["Default", "LearningRateSchedule", "LocalOptimizer", "Metrics",
           "OptimMethod", "Optimizer", "SGD", "Trigger", "make_train_step"]
