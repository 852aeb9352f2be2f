"""Core utilities of the port: metric logging."""
from .telemetry import MetricLogger

__all__ = ["MetricLogger"]
