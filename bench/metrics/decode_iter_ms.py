"""Milliseconds of decode dispatch and sync spans per decode dispatch in
the window."""

from bench.metrics._lib import *  # noqa: F401,F403


def read(rec):
    n = counter(rec, "decode_dispatches")
    sp = rec.get("spans") or {}
    if not n or "decode_dispatch" not in sp:
        return None
    return (sp["decode_dispatch"]["seconds"]
            + sp.get("decode_sync", {}).get("seconds", 0.0)) * 1e3 / n
