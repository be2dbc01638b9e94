"""Seconds from process start to the window's first request."""

from bench.metrics._lib import *  # noqa: F401,F403


def read(rec):
    return rec["setup_s"]
