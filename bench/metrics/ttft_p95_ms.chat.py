"""The traced run's 95th percentile of submit -> first token over the
window's requests: the queue of prompts waiting for the engine's
per-step prefill budget sets it."""

from bench.metrics._lib import *  # noqa: F401,F403


def read(rec):
    return p95(ttft_ms(rec))
