"""Milliseconds the host spent in the program's sync.* spans (each one
call that can wait for the card: operand and page-table uploads, the
first token's read-back) per engine step in the window; the designed
decode_sync is left out."""

from bench.metrics._lib import *  # noqa: F401,F403


def read(rec):
    n = counter(rec, "steps_run")
    sp = rec.get("spans") or {}
    waits = [s["seconds"] for k, s in sp.items() if k.startswith("sync.")]
    return sum(waits) * 1e3 / n if waits and n else None
