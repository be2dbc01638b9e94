"""Requests running per decode dispatch over the dispatch's rows
(max_batch), window totals, in percent."""

from bench.metrics._lib import *  # noqa: F401,F403


def read(rec):
    rows = [len(s["positions"]) for s in rec["steps"] if s["positions"]]
    return percent(sum(rows), len(rows) * rec["max_batch"])
