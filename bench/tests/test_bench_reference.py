"""The reference's pieces on the CPU at small sizes: the frozen formats
against the program's, the seeded draw, and the yardstick's counts
against hand counts."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from bench import roofline
from bench.reference import codecs, common, compare, jamba, llama, weights

torch.set_num_threads(1)


def _program_spec(f):
    from repro_torch.core import formats
    return formats.format_by_name(f.name)


def _probe(n=20000, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, generator=g) * torch.exp2(
        torch.randint(-12, 12, (n,), generator=g).float())
    return torch.cat([x, torch.tensor([0.0, -0.0, 1e-40, -1e-40, 1e9, -1e9,
                                       6.0, 5.0, 3.5, 0.25, 64.0, 65.0])])


@pytest.mark.parametrize("f", [codecs.POSIT8, codecs.POSIT16, codecs.FP4],
                         ids=lambda f: f.name)
def test_grid_rounds_as_the_program_does(f):
    """Values, ties (the boundaries themselves), saturation, zero."""
    from repro_torch.core import codec
    _, _, bnds = codecs._grid(f)
    x = torch.cat([_probe(), torch.as_tensor(bnds, dtype=torch.float32)])
    want = codec.quantize(_program_spec(f), x)
    assert torch.equal(codecs.quantize(f, x), want)


@pytest.mark.parametrize("f", [codecs.POSIT8, codecs.POSIT16, codecs.FP4],
                         ids=lambda f: f.name)
def test_weight_grid_equals_the_programs_packed_weight(f):
    from repro_torch.kernels.ops import pack_tensor, to_dense
    w = torch.randn(2, 96, 40, generator=torch.Generator().manual_seed(1))
    w[0, :, 3] = 0.0
    want = to_dense(pack_tensor(_program_spec(f), w))
    assert torch.equal(codecs.quantize_weight(f, w), want)


def test_cache_rows_equal_the_programs_kv_codes():
    from repro_torch.models.attention import dequantize_kv, quantize_kv
    k = torch.randn(3, 5, 2, 64, generator=torch.Generator().manual_seed(2))
    codes, scale = quantize_kv(k)
    want = dequantize_kv(codes, scale, torch.float32)
    assert torch.equal(codecs.quantize_rows(k), want)


def test_policy_formats():
    assert codecs.weight_format("layers/attn/wq/w") is codecs.POSIT8
    assert codecs.weight_format("groups/b0/mamba/out_proj/w") is \
        codecs.POSIT8
    assert codecs.weight_format("lm_head/w") is codecs.POSIT16
    assert codecs.weight_format("layers/ffn/down/w") is codecs.FP4
    assert codecs.weight_format("groups/b1/moe/experts/up") is codecs.FP4
    for kept in ("groups/b1/moe/router/w", "groups/b0/mamba/dt_proj/w",
                 "groups/b0/mamba/conv_w", "embed/table",
                 "final_norm/norm_scale"):
        assert codecs.weight_format(kept) is None


def test_draw_is_a_function_of_seed_and_slice():
    leaves = [("a/w", (3, 4), weights.uniform(4)),
              ("b", (5,), weights.normal(0.5)), ("c", (2,), ("ones",)),
              ("d", (2, 3), ("log_arange",))]
    one = weights.draw(2**33 + 5, "layers/1", leaves, "cpu")
    two = weights.draw(2**33 + 5, "layers/1", leaves, "cpu")
    other = weights.draw(2**33 + 5, "layers/2", leaves, "cpu")
    assert all(torch.equal(one[k], two[k]) for k in one)
    assert not torch.equal(one["a/w"], other["a/w"])
    assert one["a/w"].abs().max() <= 0.5
    assert torch.equal(one["d"][1], torch.log(torch.tensor([1., 2., 3.])))
    assert weights.nest({"a/b": 1, "a/c": 2}) == {"a": {"b": 1, "c": 2}}


def test_fp8_control_rounds_each_row():
    x = torch.tensor([[1.0, 0.3, -0.01], [1000.0, 3.0, 0.0]])
    y = common.fp8_rows(x)
    assert torch.allclose(y, x, rtol=2 ** -4)
    assert not torch.equal(y, x)


def test_the_controls_logits_come_out_in_bf16():
    """Under the control only the products' inputs go through float8;
    its logits are rounded to bfloat16, as the program's read-out
    writes them, and not to float8."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 5, 16, generator=g)
    head = torch.randn(16, 40, generator=g)
    rows, norm = [torch.arange(5)], torch.ones(16)
    low = common.readout(x, rows, norm, head, common.fp8_rows)[0]
    full = common.readout(x, rows, norm, head)[0]
    assert torch.equal(low, low.to(torch.bfloat16).float())
    assert not torch.equal(low, low.to(torch.float8_e4m3fn).float())
    assert not torch.equal(full, full.to(torch.bfloat16).float())


def test_gaps_in_the_readout_precision_tie_what_rounds_alike():
    """4.0 and 4.01 round alike in bfloat16 (1/32 apart at 4): serving
    either is a gap there of 0, while 1.0 below the best stays 1.0."""
    lg = [torch.tensor([[4.0, 4.01, 1.0], [2.0, 1.0, 3.0]])]
    served = [np.array([0, 1])]
    g32 = compare.served_gaps(lg, served)[0]
    g16 = compare.served_gaps(lg, served, compare.READOUT)[0]
    assert g32[0] == pytest.approx(0.01, abs=1e-6) and g16[0] == 0
    assert g32[1] == g16[1] == 2.0


def test_control_takes_the_first_of_tied_logits():
    ref = [torch.tensor([[1.0, 1.003, 0.0]])]
    low = [torch.tensor([[1.0, 1.0, 0.0]])]
    assert compare.control_gaps(ref, low)[0][0] == pytest.approx(0.003,
                                                                 abs=1e-6)
    assert compare.control_gaps(ref, low, compare.READOUT)[0][0] == 0


SMALL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 16, "d_ff": 96, "vocab": 128, "rope_theta": 1e4}


def test_rmmec_counts_by_hand():
    flops, nbytes = roofline.rmmec(512, 8192, 1024, 2, 8, 1)
    assert flops == 2 * 512 * 8192 * 1024
    assert nbytes == 512 * 8192 * 2 + 8192 * 1024 + 1024 * 4 \
        + 512 * 1024 * 4
    t, term = roofline.bound(flops, nbytes)
    assert term == "operations" and math.isclose(t, flops / 989e12)
    t, term = roofline.bound(*roofline.rmmec(1, 8192, 1024, 2, 8, 1))
    assert term == "bytes"


def test_attention_and_dequant_counts_by_hand():
    f, b = roofline.paged_decode(2, 8, 4, 128, 1, live=300, q_bytes=2)
    assert f == 4 * 300 * 8 * 4 * 128
    assert b == 2 * 8 * 4 * 128 * 2 + 300 * 2 * 8 * 130 + 2 * 8 * 4 * 128 * 4
    f, b = roofline.paged_prefill(4, 1, 2, 8, 1, start=10, q_bytes=2)
    assert f == 4 * (4 * 10 + 10) * 1 * 2 * 8          # pairs 11+12+13+14
    assert b == 4 * 2 * 8 * 2 + 14 * 2 * 1 * 10 + 4 * 2 * 8 * 4
    f, b = roofline.dequant(4096, 14336, 4, 1, 2)
    assert b == 4096 * 14336 / 2 + 14336 * 4 + 4096 * 14336 * 2


def test_model_counts_by_hand():
    m = dict(SMALL)
    model = roofline.Model.of(m, llama)
    d, f, v = 64, 96, 128
    per_layer = d * 64 + 2 * d * 32 + 64 * d + 3 * d * f
    assert model.flops_per_token == 2 * 2 * per_layer
    attn_bytes = (d * 64 + 2 * d * 32 + 64 * d) + (64 + 32 + 32 + 64) * 4
    ffn_bytes = 3 * d * f / 2 + (2 * f + d) * 4
    top = d * 4 + d * v * 2 + v * 4          # final norm, posit16 head
    assert model.weight_bytes == 2 * (attn_bytes + ffn_bytes + 2 * d * 4) \
        + top
    assert model.kv_slot_bytes == 2 * 2 * 2 * (16 + 2)
    flops, nbytes = model.step([(0, 10)], 1, [4, 9])
    pairs = 55
    assert flops == 10 * model.flops_per_token + pairs * 4 * 4 * 16 * 2 \
        + 1 * 2 * d * v + 2 * (model.flops_per_token + 2 * d * v) \
        + 15 * 4 * 4 * 16 * 2
    assert nbytes == 2 * model.weight_bytes + 10 * model.kv_slot_bytes \
        + 15 * model.kv_slot_bytes


def test_hybrid_model_counts_experts_per_token():
    m = {"n_layers": 8, "d_model": 32, "n_heads": 2, "n_kv_heads": 1,
         "head_dim": 16, "d_ff": 48, "vocab": 64, "rope_theta": 1e4,
         "n_experts": 4, "experts_per_tok": 2, "moe_d_ff": 48,
         "moe_every": 2, "attn_every": 8, "mamba_d_state": 4,
         "mamba_d_conv": 4, "mamba_expand": 2}
    model = roofline.Model.of(m, jamba)
    d, din, r = 32, 64, 2
    mamba = d * 2 * din + din * (r + 8) + r * din + din * d
    attn = d * 32 + 2 * d * 16 + 32 * d
    moe = d * 4 + 2 / 4 * 4 * 3 * d * 48
    ffn = 3 * d * 48
    assert model.flops_per_token == 2 * (7 * mamba + attn + 4 * moe
                                         + 4 * ffn)
    assert model.attn_layers == 1 and model.state_bytes > 0
