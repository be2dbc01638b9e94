"""Milliseconds of the program's decode.forward spans (the host enqueuing
the decode loop) per decode dispatch in the window."""

from bench.metrics._lib import *  # noqa: F401,F403


def read(rec):
    n = counter(rec, "decode_dispatches")
    s = (rec.get("spans") or {}).get("decode.forward")
    return s["seconds"] * 1e3 / n if s and n else None
