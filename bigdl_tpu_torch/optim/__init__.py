"""Training of the port (counterpart of bigdl_tpu.optim)."""
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import (LBFGS, SGD, Adadelta, Adagrad,
                                                Adam, Adamax, AdamW, Ftrl,
                                                LarsSGD, OptimMethod, RMSprop,
                                                wolfe_line_search)
from bigdl_tpu_torch.optim.optimizer import (CompiledTrainStep,
                                             LocalOptimizer, Optimizer,
                                             evaluate, make_train_step,
                                             predict)
from bigdl_tpu_torch.optim.prediction_service import PredictionService
from bigdl_tpu_torch.optim.schedules import (Default, EpochDecay,
                                             EpochDecayWithWarmUp, EpochStep,
                                             Exponential, LearningRateSchedule,
                                             MultiStep, NaturalExp, Plateau,
                                             Poly, PolyEpochDecay,
                                             SequentialSchedule, Step, Warmup)
from bigdl_tpu_torch.optim.triggers import Trigger
from bigdl_tpu_torch.optim.validation import (NDCG, AccuracyResult,
                                              DetectionResult, HitRatio, Loss,
                                              LossResult,
                                              MeanAveragePrecision,
                                              PrecisionRecallAUC,
                                              Top1Accuracy, Top5Accuracy,
                                              TreeNNAccuracy,
                                              ValidationMethod,
                                              ValidationResult)

__all__ = ["AccuracyResult", "Adadelta", "Adagrad", "Adam", "Adamax",
           "AdamW", "CompiledTrainStep", "Default", "DetectionResult",
           "EpochDecay", "EpochDecayWithWarmUp", "EpochStep", "Exponential",
           "Ftrl", "HitRatio", "LBFGS", "LarsSGD", "LearningRateSchedule",
           "LocalOptimizer", "Loss", "LossResult", "MeanAveragePrecision",
           "Metrics", "MultiStep", "NDCG", "NaturalExp", "OptimMethod",
           "Optimizer", "Plateau", "Poly", "PolyEpochDecay",
           "PrecisionRecallAUC", "PredictionService", "RMSprop", "SGD",
           "SequentialSchedule", "Step", "Top1Accuracy", "Top5Accuracy",
           "TreeNNAccuracy", "Trigger", "ValidationMethod",
           "ValidationResult", "Warmup", "evaluate", "make_train_step",
           "predict", "wolfe_line_search"]
