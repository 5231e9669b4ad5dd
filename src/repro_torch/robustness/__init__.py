from .validate import Deadline  # noqa: F401
