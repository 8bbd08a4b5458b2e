"""Experiment scripts of the PyTorch port (counterparts of ``experiments/``)."""
