from .fault import FailureInjector, Heartbeat, ResilientTrainer, StragglerWatchdog

__all__ = ["FailureInjector", "Heartbeat", "ResilientTrainer", "StragglerWatchdog"]
