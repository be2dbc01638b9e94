"""Share of the host's forward enqueue time (decode.forward and
prefill.forward spans) spent in the KV writes (fwd.kv_write spans) in
the window, in percent."""

from bench.metrics._lib import *  # noqa: F401,F403


def read(rec):
    sp = rec.get("spans") or {}
    kv = sp.get("fwd.kv_write")
    fwd = sum(sp.get(k, {}).get("seconds", 0.0)
              for k in ("decode.forward", "prefill.forward"))
    return percent(kv["seconds"], fwd) if kv else None
