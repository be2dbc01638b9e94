"""Deterministic, shardable synthetic LM data (the counterpart of
``repro.data.tokens``).

Every batch is a pure function of (seed, step, shard), drawn with numpy
exactly as the reference draws it, so a batch here is bitwise the
reference's for the same (seed, step, shard):
  * resume after preemption is exact (the iterator state is one integer,
    saved in the checkpoint manifest);
  * each host generates only its shard;
  * ``rebalance(num_shards, shard)`` re-partitions the same global
    stream without changing the data any step sees.

The stream is Markov-ish so models learn (the loss drops): token t+1 is
a noisy affine function of token t within a banded vocab.  ``next_batch``
hands the batch over as tensors on ``device`` (None: the card).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .. import resolve_device

__all__ = ["TokenStream"]


@dataclasses.dataclass
class TokenStream:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    step: int = 0
    shard: int = 0
    num_shards: int = 1
    frontend: str = "none"
    d_model: int = 0
    n_patches: int = 0
    device: Optional[str] = None

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.num_shards:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {self.num_shards} shards")
        return self.global_batch // self.num_shards

    def rebalance(self, num_shards: int, shard: int) -> "TokenStream":
        return dataclasses.replace(self, num_shards=num_shards, shard=shard)

    def state_dict(self) -> Dict:
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, d: Dict) -> None:
        self.seed, self.step = int(d["seed"]), int(d["step"])

    def _batch_np(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        b, s, v = self.local_batch, self.seq_len, self.vocab
        band = max(v // 64, 2)
        x = np.empty((b, s + 1), np.int32)
        x[:, 0] = rng.integers(0, v, b)
        # per-sequence drift rate: the model learns p(next | cur) quickly
        rate = rng.integers(1, band, (b, 1))
        noise = rng.integers(0, 3, (b, s)) - 1
        for t in range(s):
            x[:, t + 1] = (x[:, t] + rate[:, 0] + noise[:, t]) % v
        out = {"tokens": x[:, :-1], "labels": x[:, 1:]}
        if self.frontend == "audio":
            emb = rng.standard_normal((b, s, self.d_model)).astype(np.float32)
            out = {"frame_embeds": emb * 0.02, "labels": out["labels"]}
        elif self.frontend == "vision":
            pe = rng.standard_normal(
                (b, self.n_patches, self.d_model)).astype(np.float32)
            out["patch_embeds"] = pe * 0.02
        return out

    def next_batch(self) -> Dict[str, torch.Tensor]:
        device = resolve_device(self.device)
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in self._batch_np(self.step).items()}
        self.step += 1
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            yield self.next_batch()
