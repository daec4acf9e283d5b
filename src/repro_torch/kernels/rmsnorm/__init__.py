from .ops import rmsnorm, rmsnorm_ref  # noqa: F401
