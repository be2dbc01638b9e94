"""RMMEC's least time over its device time, for the calls launched from
prefill, in percent."""

from bench.metrics._lib import *  # noqa: F401,F403


def read(rec):
    return roofline(rec, "rmmec", "prefill")
