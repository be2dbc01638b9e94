"""Four decode steps of each of the five architectures the port took last
(gemma-2b, deepseek-67b, command-r-plus-104b, musicgen-medium,
qwen2-vl-7b; reduced, float32) on the posit8 KV cache with the paper's
mixed policy packed, against the JAX package: packed words equal, the
cache's codes and scales exactly JAX's after the steps, logits within
``LOGIT_TOL``.  musicgen embeds each code through its packed posit16
``lm_head`` (``ops.dequant``); qwen2-vl decodes at the raw position on
all three M-RoPE streams, as the reference does."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))

import _torch_frontends as F  # noqa: E402
from _torch_bridge import one_torch_thread  # noqa: E402,F401


@pytest.mark.parametrize("arch", F.NEW_ARCHS)
def test_decode_steps_posit8_packed_match_reference(arch):
    F.check_decode(arch, packed=True, quantized=True)
