from .stats import latency_summary, percentile  # noqa: F401
