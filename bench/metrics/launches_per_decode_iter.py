"""Device kernels launched under decode_dispatch per dispatch, in the
profiler window."""

from bench.metrics._lib import *  # noqa: F401,F403


def read(rec):
    prof = rec.get("profile") or {}
    n = prof.get("dispatches")
    return prof.get("kernels", {}).get("decode_dispatch", 0) / n if n else None
