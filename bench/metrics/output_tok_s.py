"""Tokens served in the window over the window's seconds."""

from bench.metrics._lib import *  # noqa: F401,F403


def read(rec):
    t0, t1 = rec["window"]
    return sum(t0 <= t <= t1 for r in rec["requests"]
               for t in r["times"]) / window(rec)
