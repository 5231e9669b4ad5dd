from .elastic import MeshPlan, plan_mesh, reshard_plan, shard_intervals  # noqa: F401
from .heartbeat import HostRecord, StragglerDetector  # noqa: F401
