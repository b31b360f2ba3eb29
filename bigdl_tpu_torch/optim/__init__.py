"""Training of the port: the local trainer, SGD, Adam, AdamW, Adagrad,
LBFGS and the schedules, triggers and validation methods (``bigdl_tpu/optim``)."""

from bigdl_tpu_torch.optim.local_optimizer import (SKIPPED_STEPS,
                                                   LocalOptimizer,
                                                   LocalValidator, Validator)
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import (LBFGS, SGD, Adagrad, Adam,
                                                AdamW, Cosine, Default,
                                                EpochDecay, EpochSchedule,
                                                EpochStep,
                                                LearningRateSchedule,
                                                OptimMethod, Poly, Regime,
                                                Step, Warmup)
from bigdl_tpu_torch.optim.optimizer import Optimizer
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import (AccuracyResult, Loss,
                                              LossResult, Top1Accuracy,
                                              Top5Accuracy, ValidationMethod,
                                              ValidationResult)

__all__ = ["AccuracyResult", "Adagrad", "Adam", "AdamW", "Cosine",
           "Default", "EpochDecay", "EpochSchedule", "EpochStep", "LBFGS",
           "LearningRateSchedule", "LocalOptimizer", "LocalValidator",
           "Loss", "Metrics", "LossResult", "OptimMethod", "Optimizer", "Poly", "Regime",
           "SGD", "SKIPPED_STEPS", "Step", "Top1Accuracy", "Top5Accuracy",
           "Trigger", "ValidationMethod", "ValidationResult", "Validator",
           "Warmup"]
