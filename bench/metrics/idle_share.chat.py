"""Share of the profiler window in which no operation ran on the card,
in percent."""

from bench.metrics._lib import *  # noqa: F401,F403


def read(rec):
    prof = rec.get("profile") or {}
    if not prof.get("window_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
