"""``lm_loss`` and every gradient leaf of the five architectures the port
took last (reduced, float32) against the JAX package, on one
``TokenStream`` batch of each config's frontend (tokens; patch
embeddings spliced in front for qwen2-vl; frame embeddings in place of
tokens for musicgen), bitwise the same on both sides.  Seq 64, so
attention runs its online softmax over two KV chunks forward and
backward.  Loss within ``REL``; a gradient leaf within ``REL`` of its
largest magnitude (f32 sums in another order), as
``test_torch_lm_loss.py`` holds the dense and MoE families; with the
paper's mixed QAT policy for the two frontend configs."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import _torch_frontends as F  # noqa: E402
from _torch_bridge import jax_to_numpy, one_torch_thread  # noqa: E402,F401
from repro.core.policy import PrecisionPolicy as JPolicy  # noqa: E402
from repro.data import TokenStream as JStream  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch.core.policy import (PrecisionPolicy,  # noqa: E402
                                     flatten_with_paths)
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.train.loop import grads_of  # noqa: E402

REL = 1e-5
CASES = [(a, False) for a in F.NEW_ARCHS] + \
    [("musicgen-medium", True), ("qwen2-vl-7b", True)]


@pytest.mark.parametrize("arch,qat", CASES,
                         ids=[f"{a}-{'paper_mixed' if q else 'fp32'}"
                              for a, q in CASES])
def test_lm_loss_and_grads_match_reference(arch, qat):
    jcfg, cfg = F.cfgs(arch)
    jp = F.params(arch)
    kw = dict(vocab=cfg.vocab, seq_len=64, global_batch=2, seed=1,
              frontend=cfg.frontend, d_model=cfg.d_model,
              n_patches=cfg.n_patches)
    jb = JStream(**kw).next_batch()
    b = TokenStream(device="cpu", **kw).next_batch()
    assert sorted(b) == sorted(jb)
    for k in b:
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))
    jpol = JPolicy.paper_mixed() if qat else None
    pol = PrecisionPolicy.paper_mixed() if qat else None
    (jl, (jce, _)), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jzoo.loss_fn(p, b, jcfg, policy=jpol),
        has_aux=True))(jp, jb)
    g, loss, ce, _ = grads_of(F.tree(jp), b, cfg, pol)
    for got, want in ((loss, jl), (ce, jce)):
        assert abs(float(got) - float(want)) <= REL * abs(float(want))
    want = dict(flatten_with_paths(jax_to_numpy(jg)))
    got = flatten_with_paths(g)
    assert [k for k, _ in got] == sorted(want)
    for path, t in got:
        assert torch.isfinite(t).all(), path
        w = want[path]
        err = np.abs(t.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= REL, (path, err)
