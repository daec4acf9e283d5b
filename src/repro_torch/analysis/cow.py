"""CoW aliasing sanitizer for ``SlurmSimulator.fork()``.

``fork()`` shares the job-store arrays (``_sub``/``_rt``/``_lim``/
``_nn``/``_ids``) and the wholesale-replaced containers (``_arr_t``/
``_arr_i``/``_q``) with the parent until the fork's first ``_register``
(``_unshare``). The contract is prose in ROADMAP.md; a violated aliasing
rule doesn't crash — it silently corrupts *sibling lanes*, which is
exactly the failure mode that breaks the paper's decision-identical
provisioning claim (and becomes a cross-tenant data race in the
multi-tenant service work).

In sanitized mode, ``fork()`` marks every shared array
``writeable=False`` (both endpoints — the parent is marked
copy-on-write too, so its next ``_register`` takes private copies
instead of writing through the frozen snapshot). Any in-place mutation
of fork-shared state then raises ``ValueError: assignment destination is
read-only`` *at the write site*, instead of corrupting whichever lanes
still alias the arrays. ``_unshare`` / wholesale replacement produce
fresh writeable arrays, so the sanitizer never changes simulation
results — only whether an aliasing bug is loud or silent.

Scope: numpy arrays only. The shared ``_jobs`` list / ``_by_id`` dict
and the boundary ``Job`` objects are Python containers the sanitizer
cannot freeze; those stay covered by ``test_cow_fork_isolation``.

``SlurmSimulator.schedule_view()`` — the one supported cross-module
read of the schedule arrays — applies this same freeze *unconditionally*
at the API boundary (every returned view array is non-writeable even
with the sanitizer off), so consumers like ``BackgroundTimeline`` can
never write through a view into a lane's private state.

Enable with ``REPRO_COW_SANITIZE=1`` in the environment, or
``repro.analysis.cow.enable()`` / the ``sanitized()`` context manager.
The test suite runs fully sanitized (tests/conftest.py).
"""
from __future__ import annotations

import contextlib
import os

#: attribute names ``fork()`` shares copy-on-write with the parent
SHARED_ARRAYS = ("_sub", "_rt", "_lim", "_nn", "_ids",
                 "_arr_t", "_arr_i", "_q")

_enabled = os.environ.get("REPRO_COW_SANITIZE", "0") not in ("", "0")


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


@contextlib.contextmanager
def sanitized(on: bool = True):
    """Temporarily force the sanitizer on (or off) for a block."""
    global _enabled
    prev = _enabled
    _enabled = bool(on)
    try:
        yield
    finally:
        _enabled = prev


def freeze_shared(sim) -> None:
    """Mark ``sim``'s fork-shared arrays read-only (in place: the parent
    aliases the same objects, so both endpoints are protected). Empty
    arrays are skipped — the module-level empty sentinels are shared
    across unrelated simulators and a zero-size array cannot be
    meaningfully written anyway."""
    for name in SHARED_ARRAYS:
        arr = getattr(sim, name)
        if arr.size:
            arr.flags.writeable = False
