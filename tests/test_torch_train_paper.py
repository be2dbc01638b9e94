"""Five train steps with every paper feature -- QAT under the paper's
mixed policy, posit8 AdamW moments, posit8 gradient compression with
error feedback, microbatch 2 -- in the port and in the JAX package from
one init and the same batches (float32 reduced qwen2-0.5b, on the CPU).

The losses agree within ``PAPER_REL``: float32 sums run in another
order, and once the two runs differ by an ulp a weight or gradient near
a rounding boundary of its format may land on the other side."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))

from _torch_bridge import both_train_runs, one_torch_thread  # noqa: E402,F401

PAPER_REL = 1e-3


def test_five_steps_match_reference_all_paper_features():
    mine, ref, state = both_train_runs(
        5, qat=True, precision_policy="mixed", opt_state_dtype="posit8",
        grad_compression="posit8", microbatch=2)
    rel = np.abs(mine - ref) / np.abs(ref)
    assert rel.max() <= PAPER_REL, (mine, ref, rel)
    assert np.isfinite(mine).all() and state.residuals is not None
    assert int(state.step) == 5
