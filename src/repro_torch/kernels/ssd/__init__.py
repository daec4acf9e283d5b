from .ops import ssd, ssd_ref  # noqa: F401
