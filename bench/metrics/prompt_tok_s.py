"""Prompt tokens of the requests whose first token came in the window,
over the window's seconds (prefix-cached tokens count as served)."""

from bench.metrics._lib import *  # noqa: F401,F403


def read(rec):
    t0, t1 = rec["window"]
    return sum(r["prompt"] for r in rec["requests"]
               if r["times"] and t0 <= r["times"][0] <= t1) / window(rec)
