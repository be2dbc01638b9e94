"""Milliseconds of the program's prefill.forward spans (the host
enqueuing one chunk's forward) per chunk in the window."""

from bench.metrics._lib import *  # noqa: F401,F403


def read(rec):
    s = (rec.get("spans") or {}).get("prefill.forward")
    return s["seconds"] * 1e3 / s["count"] if s and s["count"] else None
