"""Training of the port (counterpart of bigdl_tpu.optim)."""
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import SGD, Adam, OptimMethod
from bigdl_tpu_torch.optim.optimizer import (LocalOptimizer, Optimizer,
                                             evaluate, make_train_step)
from bigdl_tpu_torch.optim.schedules import Default, LearningRateSchedule
from bigdl_tpu_torch.optim.triggers import Trigger
from bigdl_tpu_torch.optim.validation import (AccuracyResult, Loss,
                                              LossResult, Top1Accuracy,
                                              ValidationMethod,
                                              ValidationResult)

__all__ = ["AccuracyResult", "Adam", "Default", "LearningRateSchedule",
           "LocalOptimizer", "Loss", "LossResult", "Metrics", "OptimMethod",
           "Optimizer", "SGD", "Top1Accuracy", "Trigger", "ValidationMethod",
           "ValidationResult", "evaluate", "make_train_step"]
