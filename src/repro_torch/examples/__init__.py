"""The port's counterparts of ``examples/*.py``: the same flags, defaults,
scenarios, seeds, configs and printed lines, on one CUDA card unless
``--device cpu`` is given. Run one with ``python -m
repro_torch.examples.<name>``; each ``main(argv)`` returns a dict of what
it printed."""
