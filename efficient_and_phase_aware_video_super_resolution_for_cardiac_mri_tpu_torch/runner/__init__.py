from . import checkpoint, common, loggers, monitor, optim, predictors, streaming, trainers

__all__ = ["checkpoint", "common", "loggers", "monitor", "optim", "predictors", "streaming",
           "trainers"]
