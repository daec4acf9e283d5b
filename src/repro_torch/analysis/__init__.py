"""Runtime checks copied from ``repro.analysis``: the CoW aliasing
sanitizer (``cow``) that the simulator consults on ``fork()``."""
