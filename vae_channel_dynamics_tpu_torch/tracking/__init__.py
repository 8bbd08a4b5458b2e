from .deadneuron import DeadNeuronTracker
from .monitor import ActivityMonitor

__all__ = ["ActivityMonitor", "DeadNeuronTracker"]
