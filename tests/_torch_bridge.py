"""Test-only JAX -> numpy step of the port's bridge: a JAX parameter or
cache tree becomes nested dicts of numpy arrays, with each PackedTensor
as a dict of its words, scales, mask, shape, spec name and group
(``repro_torch.bridge.params_from_numpy`` takes it from there), the
one-thread fixture the port's test modules share, and the two packages'
train runs side by side."""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port tests' tensors are small: one intra-op thread a worker
    keeps the parallel test run from oversubscribing the cores.  A test
    module takes it with ``from _torch_bridge import one_torch_thread``;
    the setting is restored after the module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_to_numpy(tree):
    # the JAX package loads here, not at import: a module that takes only
    # the fixture stays free of jax
    from repro.kernels.ops import PackedTensor

    if isinstance(tree, PackedTensor):
        return {"words": np.asarray(tree.words).view(np.int32),
                "scales": np.asarray(tree.scales),
                "mask": np.asarray(tree.mask),
                "shape": tuple(tree.shape), "spec": tree.spec.name,
                "group": tree.group}
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def both_train_runs(steps, arch="qwen2-0.5b", **kw):
    """(port losses, JAX losses, port state) of ``steps`` train steps of
    the float32 reduced ``arch`` from the reference's init state, each
    package on its own ``TokenStream`` of the same seed; ``kw`` are
    ``RunConfig`` fields."""
    import dataclasses

    import jax
    from repro.configs import get_config as jget
    from repro.configs.base import RunConfig as JRun
    from repro.data import TokenStream as JStream
    from repro.train import loop as jloop
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.train.loop import TrainState, build_train_step

    run_kw = dict(arch="t", steps=steps, lr=3e-3, warmup_steps=2,
                  checkpoint_every=0, **kw)
    jrun, run = JRun(**run_kw), RunConfig(**run_kw)
    jcfg = dataclasses.replace(jget(arch).reduced(), dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    jstate = jloop.init_state(jax.random.PRNGKey(0), jcfg, jrun)
    jstep = jloop.build_train_step(jcfg, jrun, donate=False)
    state = TrainState(torch.zeros((), dtype=torch.int32), *(
        None if t is None else params_from_numpy(jax_to_numpy(t), "cpu")
        for t in (jstate.params, jstate.opt_state, jstate.residuals)))
    step = build_train_step(cfg, run)
    data_kw = dict(vocab=cfg.vocab, seq_len=64, global_batch=8)
    jdata, data = JStream(**data_kw), TokenStream(device="cpu", **data_kw)
    mine, ref = [], []
    for _ in range(steps):
        jstate, jm = jstep(jstate, jdata.next_batch())
        state, m = step(state, data.next_batch())
        ref.append(float(jm["loss"]))
        mine.append(float(m["loss"]))
    return np.array(mine), np.array(ref), state
