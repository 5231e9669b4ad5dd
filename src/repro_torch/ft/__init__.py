from .heartbeat import HostRecord, StragglerDetector  # noqa: F401
