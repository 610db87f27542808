"""The fault-injection axis of the FL runtimes: not ported yet.

The JAX package's fault registry (``repro.fed.fleet.faults``) names its
no-fault profile ``"none"``, and a run under it is a run without faults.
The port runs no other profile yet (ROADMAP item 12), so its runtimes
take ``None`` and ``"none"`` alike and raise for every other profile.
"""
from __future__ import annotations

NO_FAULTS = "none"


def check_no_faults(faults) -> str:
    """The name of the run's fault profile, ``"none"``, for ``faults``
    None or ``"none"``; any other profile raises ``NotImplementedError``
    naming ROADMAP item 12."""
    if faults is None or (isinstance(faults, str) and faults == NO_FAULTS):
        return NO_FAULTS
    raise NotImplementedError(
        f"fault profile {faults!r} is not ported yet: fault injection is "
        f"ROADMAP item 12 (only None or {NO_FAULTS!r})")
