"""A cell cut to a size the CPU runs in seconds: the same files, engine
settings and traffic kind, every width and count made small."""

from __future__ import annotations

import json

from bench import harness, traffic


def tiny_cell(name: str) -> dict:
    cell = harness.load_cell(name)
    m = cell["cfg"]["model"]
    m.update(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
             vocab=256)
    if m["family"] == "dense":
        m["n_layers"] = 2
    else:
        m["moe_d_ff"] = 96
    e = cell["engine"]
    e.update(max_batch=4, page_size=16, max_len=128, n_pages=40,
             prefill_chunk_tokens=32)
    if "n_state_slabs" in e:
        e["n_state_slabs"] = 4
    cell["check"] = json.loads(json.dumps(cell["check"]))
    return cell


def small_traffic(monkeypatch) -> None:
    """Four clients, short turns, a 32-token preamble where there is one."""
    load = traffic.load

    def small(mix):
        p = load(mix)
        p.update(clients=4, depth=8, user_tokens=[4, 24],
                 reply_tokens=[2, 8])
        if p.get("preamble_tokens"):
            p["preamble_tokens"] = 32
        return p

    monkeypatch.setattr(traffic, "load", small)
