"""Milliseconds of the engine's prefill spans per 1000 prompt tokens it
computed in the window, in a cell whose prompts run through the host's
token loop (the closed loop's output waits on it)."""

from bench.metrics._lib import *  # noqa: F401,F403


def read(rec):
    return prefill_ms_per_ktok(rec)
