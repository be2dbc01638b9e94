"""Closed-loop chat traffic.

Each of ``clients`` clients sends ``depth`` requests in turn, the next
as soon as the last reply has finished.  A prompt is an optional
``preamble_tokens``-token system preamble, the same for every request,
followed by a user turn of ``user_tokens`` [lo, hi] tokens; a reply is
``reply_tokens`` [lo, hi] greedy tokens.  Both lengths are log-uniform:
every seed gets the same stratified set of lengths (the quantiles
(i + 1/2) / N of the log-uniform law over all ``clients x depth``
requests), dealt to the requests in a seeded order, so seeds change
which request is long and not how much work there is.  Token ids are
uniform over the vocabulary.  ``lead_clients`` clients start alone (with
a preamble, one client puts it into the prefix cache before the others
arrive)."""

from __future__ import annotations

import numpy as np

__all__ = ["make", "log_uniform_set"]


def log_uniform_set(lo: int, hi: int, n: int) -> np.ndarray:
    """n lengths at the log-uniform law's quantiles (i + 1/2) / n."""
    q = (np.arange(n) + 0.5) / n
    return np.rint(np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))
                   ).astype(np.int64)


def make(params: dict, seed: int, vocab: int):
    clients, depth = int(params["clients"]), int(params["depth"])
    n = clients * depth
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                 0x7AFF1C])
    users = rng.permutation(log_uniform_set(*params["user_tokens"], n))
    replies = rng.permutation(log_uniform_set(*params["reply_tokens"], n))
    pre = rng.integers(0, vocab, int(params.get("preamble_tokens", 0)))
    out = []
    for c in range(clients):
        reqs = []
        for j in range(depth):
            i = c * depth + j
            prompt = np.concatenate(
                [pre, rng.integers(0, vocab, int(users[i]))]).astype(np.int32)
            reqs.append((prompt, int(replies[i])))
        out.append(reqs)
    return out, int(params.get("lead_clients", 0))
