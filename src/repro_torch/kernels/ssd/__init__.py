from .ops import ssd, ssd_bwd, ssd_bwd_ref, ssd_ref  # noqa: F401
