"""Helpers of the port: torch names of the model's modules and parameters,
config loading, logging setup and the metric reporters."""
