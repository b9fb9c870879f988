"""A kernel's share of its roofline over a traced window.

The hooks count the launches the program made in the window and the work
model bounds each; the profiler gives the device time of the kernel's
launches it traced.  A launch at the window's edge can fall on one side
and not the other, or begin in an entry point that was called before the
hooks went in (and so count as unmodelled), so the share is taken per
launch: the mean bound of the modelled launches over the mean device
time.  Where more than one launch in a hundred is unmodelled the share
reads nothing.
"""

from __future__ import annotations

from portbench.workmodel import bound_s

__all__ = ["share"]


def share(ctx, kernel: str, fragment: str) -> float | None:
    launches = [launch for launch in ctx.launches if launch.kernel == kernel]
    if ctx.trace is None or not launches or 100 * ctx.unmodelled.get(kernel, 0) > len(launches):
        return None
    seconds, count = ctx.trace.kernel_time(fragment)
    if count == 0 or seconds <= 0:
        return None
    mean_bound = sum(bound_s(launch) for launch in launches) / len(launches)
    return 100.0 * mean_bound / (seconds / count)
