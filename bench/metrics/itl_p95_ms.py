"""95th percentile of the gaps between consecutive tokens in the window."""

from bench.metrics._lib import *  # noqa: F401,F403


def read(rec):
    return p95(itl_ms(rec))
