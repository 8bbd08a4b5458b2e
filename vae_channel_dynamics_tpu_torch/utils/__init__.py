"""Helpers of the port: torch names of the model's modules and parameters."""
