"""The traced run's 95th percentile of submit -> first token, in a cell
whose tails only the host paces."""

from bench.metrics._lib import *  # noqa: F401,F403


def read(rec):
    return p95(ttft_ms(rec))
