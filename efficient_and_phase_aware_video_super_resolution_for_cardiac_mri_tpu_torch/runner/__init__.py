from . import checkpoint, common, loggers, monitor, optim, predictors, trainers

__all__ = ["checkpoint", "common", "loggers", "monitor", "optim", "predictors", "trainers"]
