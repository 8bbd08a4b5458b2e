from .classifier import RegionClassifier

__all__ = ["RegionClassifier"]
