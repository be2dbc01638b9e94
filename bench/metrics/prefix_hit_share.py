"""Prompt tokens served from the prefix cache over the prompt tokens
admitted in the window, in percent."""

from bench.metrics._lib import *  # noqa: F401,F403


def read(rec):
    hit = counter(rec, "prefix_hit_tokens")
    if hit is None:
        return None
    return percent(hit, sum(s["admitted_prompt_tokens"] for s in rec["steps"]))
