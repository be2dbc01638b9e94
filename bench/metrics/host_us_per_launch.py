"""Microseconds of the host's decode enqueue (decode_enqueue_ms) per
kernel launched under a decode dispatch (as launches_per_decode_iter
counts them in the profiler window)."""

from bench.metrics._lib import *  # noqa: F401,F403


def read(rec):
    n = counter(rec, "decode_dispatches")
    s = (rec.get("spans") or {}).get("decode.forward")
    prof = rec.get("profile") or {}
    disp = prof.get("dispatches")
    launches = prof.get("kernels", {}).get("decode_dispatch", 0) / disp \
        if disp else 0
    if not (s and n and launches):
        return None
    return 1e3 * (s["seconds"] * 1e3 / n) / launches
