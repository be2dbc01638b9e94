"""The port's ``roofline/`` against the reference's ``repro.roofline``:
every function of the model arithmetic gives exactly the reference's
Python floats for the ten configs (full and ``.reduced()``) x every
``SHAPES`` entry, and the dry run's wire model equals the reference's
HLO parser on lines that carry the same shapes.  ``hw.py`` holds the
H100 and no TPU constant; ``detect`` refuses a card it does not know."""

import dataclasses
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))

from _torch_bridge import one_torch_thread  # noqa: E402,F401
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.roofline import analysis as ref_ra  # noqa: E402
from repro.roofline import hw as ref_hw  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.roofline import analysis as ra  # noqa: E402
from repro_torch.roofline import hw  # noqa: E402

# one set of peaks handed to both packages (the H100's numbers)
PEAKS = dict(name="test", peak_flops_bf16=989e12, hbm_bw=3.35e12,
             ici_bw=450e9, hbm_bytes=80e9)


def _pair(arch, reduced):
    cfg, ref = get_config(arch), ref_get_config(arch)
    return (cfg.reduced(), ref.reduced()) if reduced else (cfg, ref)


def _ref_shape(name):
    from repro.configs import SHAPES as REF_SHAPES
    return REF_SHAPES[name]


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_arithmetic_equals_reference(arch, reduced):
    cfg, ref = _pair(arch, reduced)
    assert ra.active_param_count(cfg) == ref_ra.active_param_count(ref)
    assert ra.total_param_count(cfg) == ref_ra.total_param_count(ref)
    for sname, shape in SHAPES.items():
        rshape = _ref_shape(sname)
        assert ra.model_flops(cfg, shape) == ref_ra.model_flops(ref, rshape)
        for qkv in (False, True):
            for bits in (4.5, 16.0):
                got = ra.min_traffic_bytes(cfg, shape, bits, qkv)
                want = ref_ra.min_traffic_bytes(ref, rshape, bits, qkv)
                assert got == want, (sname, qkv, bits)
        if not cfg.n_heads:
            continue
        for group in (None, 32):
            for la in (True, False):
                for quant in (False, True):
                    kw = dict(quantized=quant, kv_group=group,
                              length_aware=la, blk=64)
                    got = ra.decode_kv_bytes(cfg, 3, shape.seq_len,
                                             shape.seq_len // 3, **kw)
                    want = ref_ra.decode_kv_bytes(ref, 3, shape.seq_len,
                                                  shape.seq_len // 3, **kw)
                    assert got == want, (sname, kw)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_terms_and_summary_equal_reference(arch, reduced):
    cfg, ref = _pair(arch, reduced)
    mine, theirs = hw.HW(**PEAKS), ref_hw.HW(**PEAKS)
    cost = {"flops": 6.1e11, "bytes accessed": 2.1e9}
    colls = {"wire_bytes": 6.5e7, "operand_bytes": 1.7e7, "count": 28.0}
    for sname, shape in SHAPES.items():
        for chips in (1, 256):
            for per_dev in (True, False):
                t = ra.roofline_terms(cost, colls, chips, mine, per_dev)
                assert t == ref_ra.roofline_terms(cost, colls, chips, theirs,
                                                  per_dev)
            for qkv in (False, True):
                got = ra.summarize_cell(cfg, shape, t, chips, mine, 4.5, qkv)
                want = ref_ra.summarize_cell(ref, _ref_shape(sname), t, chips,
                                             theirs, 4.5, qkv)
                assert got == want, (sname, chips, qkv)


def _hlo(op, rshape, oshape):
    return (f"  %x.1 = {rshape} {op}({oshape} %p.0), replica_groups={{}}, "
            f"dimensions={{0}}")


# (op, result shape, operand shape, result bytes, operand bytes)
CALLS = [
    ("all-gather", "bf16[16,896]{1,0}", "bf16[1,896]{1,0}", 16 * 896 * 2,
     896 * 2),
    ("all-reduce", "f32[1024,64]{1,0}", "f32[1024,64]{1,0}", 1024 * 64 * 4,
     1024 * 64 * 4),
    ("reduce-scatter", "f32[64]{0}", "f32[1024]{0}", 64 * 4, 1024 * 4),
    ("all-to-all", "bf16[8,128,64]{2,1,0}", "bf16[8,128,64]{2,1,0}",
     8 * 128 * 64 * 2, 8 * 128 * 64 * 2),
    ("collective-permute", "s32[8]{0}", "s32[8]{0}", 32, 32),
    ("all-gather", "u8[4096]{0}", "u8[256]{0}", 4096, 256),
]


def test_wire_model_equals_hlo_parser():
    text = "\n".join(["HloModule m", "  %a = f32[2]{0} add(f32[2] %b)"]
                     + [_hlo(op, r, o) for op, r, o, _, _ in CALLS])
    got = ra.collective_stats([(op, ob, rb) for op, _, _, rb, ob in CALLS])
    assert got == ref_ra.collective_stats(text)
    assert got["count"] == len(CALLS)
    with pytest.raises(ValueError, match="unknown collective"):
        ra.collective_stats([("broadcast", 4, 4)])


def test_hw_is_the_h100_only():
    assert hw.H100_SXM.peak_flops_bf16 == 989e12
    assert hw.H100_SXM.peak_flops_f32 == 67e12
    assert hw.H100_SXM.hbm_bw == 3.35e12
    assert hw.H100_SXM.ici_bw == 450e9
    assert hw.H100_SXM.hbm_bytes == 80e9
    entries = [v for v in vars(hw).values() if isinstance(v, hw.HW)]
    assert entries == [hw.H100_SXM]
    fields = {f.name for f in dataclasses.fields(ref_hw.HW)}
    assert fields <= {f.name for f in dataclasses.fields(hw.HW)}
    assert ra.roofline_terms.__defaults__[0] is hw.H100_SXM


class _Props:
    def __init__(self, name, total_memory):
        self.name, self.total_memory = name, total_memory


@pytest.mark.parametrize("name,mem,known", [
    ("NVIDIA H100 80GB HBM3", 85_031_714_816, True),
    ("NVIDIA H100 PCIe", 85_031_714_816, False),
    ("NVIDIA A100-SXM4-80GB", 85_031_714_816, False),
    ("NVIDIA H100 80GB HBM3", 40e9, False),
])
def test_detect(monkeypatch, name, mem, known):
    import torch
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: _Props(name, mem))
    if known:
        assert hw.detect() is hw.H100_SXM
    else:
        with pytest.raises(ValueError, match="no roofline entry"):
            hw.detect()
