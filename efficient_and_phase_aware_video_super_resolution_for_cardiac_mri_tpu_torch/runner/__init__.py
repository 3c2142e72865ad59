from . import checkpoint, common, predictors

__all__ = ["checkpoint", "common", "predictors"]
