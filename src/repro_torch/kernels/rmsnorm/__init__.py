from .ops import rmsnorm, rmsnorm_bwd, rmsnorm_bwd_ref, rmsnorm_ref  # noqa: F401
