"""The window's share of the card's peak: over its steps, the larger of
the useful operations over 989 TFLOP/s and the least bytes over
3.35 TB/s, summed, over the window's seconds, in percent."""

from bench.metrics._lib import *  # noqa: F401,F403


def read(rec):
    steps = rec["steps"]
    if not steps or "chunks" not in steps[0]:
        return None
    return percent(least_s(rec), window(rec))
