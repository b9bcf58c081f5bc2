from .profiling import device_sync, phase_timer, trace

__all__ = ["device_sync", "phase_timer", "trace"]
