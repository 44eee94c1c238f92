"""A kernel's share of its roofline from the traced ranges around its
wrapper: the sum of the calls' bounds over the sum of the device time the
calls launched.  A range's name carries its call's shape after "|", as
comma-separated integers."""

from __future__ import annotations

from typing import Callable, Dict, Optional


def share(trace, bounds: Dict[str, Callable]) -> Optional[float]:
    """bounds: range name -> bound in seconds from the call's shape; None
    when no such call ran or none launched device work."""
    bound_s = device_s = 0.0
    for name, fn in bounds.items():
        for label, secs in trace.ranges_named(name):
            shape = [int(x) for x in label.split("|", 1)[1].split(",")]
            bound_s += fn(shape)
            device_s += secs
    if device_s <= 0.0:
        return None
    return 100.0 * bound_s / device_s
