"""The paged posit8 KV write (``repro_torch.kernels.kv_write``).

On the CPU: the entry point equals the pool write the engines ran before
it (``quantize_kv`` and index writes, with the page-table addressing of
``models/attention.py``), for decode and chunk addressing, pad blocks past
the table on the parking page, one and several scale groups, bfloat16
and float32 rows; the layout rule gives every (Dh, Gs) a layout or none,
and each layout it gives reduces exactly one scale group per (step span,
lane group, element group); the card path refuses the operands the
kernel does not take; the fake-tensor dry run counts one launch a layer
and forward with its bytes.

On the card (skipped without one; the kernel has no CPU mode): codes and
scales bitwise the plain version's at the serving shapes and at Dh 64,
256 and wide heads, through NaN, +-Inf, zero groups, bfloat16
subnormals, posit8 rounding boundaries and ties, every bfloat16
magnitude through the scale, parked rows; refusals with nothing
launched; one launch a layer and forward in a reduced continuous run;
the continuous and disaggregated engines serving the same tokens into
byte-equal pools with the plain version forced.  This file imports no JAX, so it runs on the card as it is."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from _torch_bridge import one_torch_thread  # noqa: E402,F401
from repro_torch.kernels import fake, kv_write  # noqa: E402
from repro_torch.kernels.kv_write import (paged_kv_write,  # noqa: E402
                                          paged_kv_write_plain, write_layout)
from repro_torch.kernels.ref import quantize_kv  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("k_codes", "v_codes", "k_scale", "v_scale")


# ---------------------------------------------------------------------------
# the pool write as the engines ran it before the kernel
# ---------------------------------------------------------------------------

def _group(pool):
    gs = pool["k_scale"].shape[-1]
    return None if gs == 1 else pool["k_codes"].shape[-1] // gs


def _before_pool_write(pool, k, v, index):
    group = _group(pool)
    for name, new in (("k", k), ("v", v)):
        codes, scale = quantize_kv(new, group)
        pool[f"{name}_codes"][index] = codes
        pool[f"{name}_scale"][index] = scale


def _before_decode(pool, k, v, page_table, positions):
    psize = pool["k_codes"].shape[1]
    pos = positions.long()
    pg = page_table.gather(1, (pos // psize)[:, None])[:, 0].long()
    _before_pool_write(pool, k, v, (pg, pos % psize))


def _before_chunk(pool, k, v, page_table, start):
    psize = pool["k_codes"].shape[1]
    b, c, kh, hd = k.shape
    nblk = c // psize
    npp = page_table.shape[1]
    blk_ids = start[:, None].long() // psize \
        + torch.arange(nblk, device=k.device)[None]
    pgs = torch.where(blk_ids < npp,
                      page_table.gather(1, blk_ids.clamp(max=npp - 1)),
                      0).reshape(-1).long()
    _before_pool_write(pool, k.reshape(b * nblk, psize, kh, hd),
                       v.reshape(b * nblk, psize, kh, hd), pgs)


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------

def _pool(n_pages, page, kh, dh, gs, seed, device="cpu"):
    """A pool of random codes and po2 scales (page 0 the parking page)."""
    gen = torch.Generator().manual_seed(seed)
    codes = (n_pages, page, kh, dh)
    scales = codes[:-1] + (gs,)
    pool = {}
    for name in ("k", "v"):
        pool[f"{name}_codes"] = torch.randint(0, 256, codes, generator=gen,
                                              dtype=torch.uint8)
        pool[f"{name}_scale"] = (2.0 ** torch.randint(
            -4, 5, scales, generator=gen)).to(torch.bfloat16)
    return {k: t.to(device) for k, t in pool.items()}


def _clone(pool):
    return {k: t.clone() for k, t in pool.items()}


def _rows(shape, seed, dtype, device="cpu"):
    """Normal rows at magnitudes spread over 2^-20 .. 2^20 by row."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) * 2.0 ** rng.integers(
        -20, 21, size=shape[:-1] + (1,))
    return torch.from_numpy(x.astype(np.float32)).to(dtype).to(device)


def _decode_case(b, kh, dh, gs, page, n_pages, np_cols, dtype, seed,
                 device="cpu", parked=()):
    """A decode write: every request on its own pages at a random
    position; rows in ``parked`` re-mapped to page 0, position 0."""
    rng = np.random.default_rng(seed)
    pages = rng.permutation(np.arange(1, n_pages))[:b * np_cols]
    table = pages.reshape(b, np_cols).astype(np.int32)
    pos = rng.integers(0, np_cols * page, size=b).astype(np.int32)
    for r in parked:
        table[r], pos[r] = 0, 0
    k = _rows((b, 1, kh, dh), seed + 1, dtype, device)[:, 0]
    v = _rows((b, 1, kh, dh), seed + 2, dtype, device)[:, 0]
    return (_pool(n_pages, page, kh, dh, gs, seed + 3, device), k, v,
            torch.from_numpy(table).to(device), torch.from_numpy(pos).to(device))


def _chunk_case(b, c, kh, dh, gs, page, n_pages, np_cols, starts, dtype,
                seed, device="cpu"):
    rng = np.random.default_rng(seed)
    pages = rng.permutation(np.arange(1, n_pages))[:b * np_cols]
    table = pages.reshape(b, np_cols).astype(np.int32)
    k = _rows((b, c, kh, dh), seed + 1, dtype, device)
    v = _rows((b, c, kh, dh), seed + 2, dtype, device)
    start = torch.tensor(starts, dtype=torch.int32, device=device)
    return (_pool(n_pages, page, kh, dh, gs, seed + 3, device), k, v,
            torch.from_numpy(table).to(device), start)


def _assert_pools_equal(got, want, parking=True):
    """Bitwise equal leaves; ``parking`` False skips page 0, which rows
    that share a slot write in no set order."""
    for key in KEYS:
        a, b = got[key], want[key]
        if not parking:
            a, b = a[1:], b[1:]
        if key.endswith("scale"):
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), key


# ---------------------------------------------------------------------------
# the CPU path is the pool write as it was
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("gs", [1, 4])
def test_decode_equals_the_pool_write_before(dtype, gs):
    pool, k, v, table, pos = _decode_case(6, 2, 32, gs, 8, 40, 4, dtype, 0,
                                          parked=(2, 5))
    want = _clone(pool)
    _before_decode(want, k, v, table, pos)
    paged_kv_write(pool, k, v, table, positions=pos)
    _assert_pools_equal(pool, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("gs", [1, 4])
def test_chunk_equals_the_pool_write_before(dtype, gs):
    """Request 1's chunk starts at logical block 3 of a 4-column table:
    its second page is the pad past the table, on the parking page."""
    pool, k, v, table, start = _chunk_case(2, 16, 2, 32, gs, 8, 40, 4,
                                           [8, 24], dtype, 1)
    want = _clone(pool)
    _before_chunk(want, k, v, table, start)
    before0 = pool["k_codes"][0].clone()
    paged_kv_write(pool, k, v, table, start=start)
    _assert_pools_equal(pool, want)
    assert not torch.equal(pool["k_codes"][0], before0)   # the pad landed


def test_entry_refuses_bad_operands():
    pool, k, v, table, pos = _decode_case(2, 2, 32, 1, 8, 12, 2,
                                          torch.float32, 2)
    with pytest.raises(ValueError, match="exactly one"):
        paged_kv_write(pool, k, v, table)
    with pytest.raises(ValueError, match="do not match"):
        paged_kv_write(pool, k[:, :1], v[:, :1], table, positions=pos)
    with pytest.raises(ValueError, match="whole pages"):
        paged_kv_write(pool, k[:, None], v[:, None], table, start=pos)


# ---------------------------------------------------------------------------
# the layout rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dh,gs,want", [
    (128, 1, (4, 32, 4, 1)),       # the cell: deepseek-67b, qwen2-vl
    (64, 1, (2, 32, 2, 1)),        # qwen2-0.5b, musicgen
    (256, 1, (4, 32, 4, 2)),       # gemma-2b
    (320, 1, (2, 32, 2, 5)),       # wide heads
    (4096, 1, (4, 32, 4, 32)),
    (112, 1, (1, 32, 1, 4)),
    (32, 1, (1, 32, 1, 1)),
    (40, 1, (1, 32, 1, 2)),
    (128, 4, (4, 8, 4, 1)),        # group 32
    (128, 16, (4, 2, 4, 1)),       # group 8
    (128, 64, (4, 1, 2, 1)),       # group 2
    (256, 2, (4, 32, 4, 1)),       # group 128
    (64, 2, (2, 16, 2, 1)),
    (112, 7, (1, 16, 1, 1)),
    (96, 2, None),                 # group 48: neither divides the step
    (192, 4, None),
])
def test_write_layout_routes_each_shape(dh, gs, want):
    assert write_layout(dh, gs) == want


def _groups_of_layout(dh, gs, layout):
    """The sets of columns the kernel reduces together, and the columns
    that store a scale, for ``layout`` (a model of csrc/kv_write.cu)."""
    vec, lanes, eg, span = layout
    steps = -(-dh // (32 * vec))
    sets, stores = {}, []
    g = dh // gs
    for t0 in range(0, steps, span):
        for t in range(t0, t0 + span):
            for lane in range(32):
                for i in range(vec):
                    e = (t * 32 + lane) * vec + i
                    if e < dh:
                        sets.setdefault((t0, lane // lanes, i // eg),
                                        set()).add(e)
        for lane in range(32):
            for i in range(vec):
                e = (t0 * 32 + lane) * vec + i
                if e < dh and e % g == 0:
                    stores.append(e)
    return list(sets.values()), stores


def test_every_layout_reduces_whole_groups():
    """For every Dh up to 512 and every Gs dividing it that the rule
    takes, each reduction set is one whole group and each group stores
    its scale once; the shapes it refuses are named."""
    plain = []
    for dh in list(range(1, 513)) + [1024, 4096]:
        for gs in (d for d in range(1, dh + 1) if dh % d == 0):
            layout = write_layout(dh, gs)
            if layout is None:
                plain.append((dh, gs))
                continue
            g = dh // gs
            sets, stores = _groups_of_layout(dh, gs, layout)
            assert sorted(sorted(s) for s in sets) == [
                list(range(i * g, (i + 1) * g)) for i in range(gs)], (dh, gs)
            assert sorted(stores) == [i * g for i in range(gs)], (dh, gs)
    # only groups that are neither a power of two below a step nor whole
    # steps nor the whole row are refused
    for dh, gs in plain:
        g = dh // gs
        assert g != dh and g & (g - 1), (dh, gs)
    assert (96, 2) in plain and (128, 4) not in plain


def test_kernel_takes_only_aligned_bf16_and_f32_rows():
    pool, k, v, table, pos = _decode_case(4, 2, 128, 1, 8, 20, 2,
                                          torch.bfloat16, 3)
    args = kv_write._launch_args
    assert args(pool, k, v, table, pos) == ((4, 32, 4, 1), [256, 0],
                                            [256, 0])
    with pytest.raises(ValueError, match="both bfloat16"):
        args(pool, k.half(), v.half(), table, pos)
    with pytest.raises(ValueError, match="both bfloat16"):
        args(pool, k, v.float(), table, pos)
    wide = torch.zeros((4, 2, 130), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):     # 4-byte aligned
        args(pool, wide[..., 2:], v, table, pos)
    with pytest.raises(ValueError, match="int32"):
        args(pool, k, v, table.long(), pos)
    # a page table or positions off the rows' device is refused before
    # the kernel could read it through a device pointer
    with pytest.raises(ValueError, match="on cpu"):
        args(pool, k, v, table.to("meta"), pos)
    with pytest.raises(ValueError, match="on cpu"):
        args(pool, k, v, table, pos.to("meta"))
    with pytest.raises(ValueError, match="on cpu"):
        args({**pool, "v_scale": pool["v_scale"].to("meta")}, k, v, table,
             pos)
    # a group the layout rule gives no layout
    pool96, k96, v96, table96, pos96 = _decode_case(4, 2, 96, 2, 8, 20, 2,
                                                    torch.bfloat16, 3)
    with pytest.raises(ValueError, match="group of 48"):
        args(pool96, k96, v96, table96, pos96)
    # a request of one: its dimension's stride is not the kernel's, as
    # for the engine's chunk starts (a view of the positions' first column)
    one = torch.zeros((1, 32, 2, 128), dtype=torch.bfloat16)[:, ::2]
    starts = torch.zeros((1, 5), dtype=torch.int32)[:, 0]
    assert starts.stride() == (5,)
    assert args(pool, one, one, table[:1], starts) == ((4, 32, 4, 1),
                                                        [0, 512], [0, 512])


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def test_fake_call_counts_one_launch_with_its_bytes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    class Rec:
        def __init__(self):
            self.ops = []

        def kernel(self, name, flops, nbytes):
            self.ops.append((name, flops, nbytes))

    with FakeTensorMode():
        pool = {"k_codes": torch.empty((9, 16, 8, 128), dtype=torch.uint8),
                "v_codes": torch.empty((9, 16, 8, 128), dtype=torch.uint8),
                "k_scale": torch.empty((9, 16, 8, 4), dtype=torch.bfloat16),
                "v_scale": torch.empty((9, 16, 8, 4), dtype=torch.bfloat16)}
        k = torch.empty((2, 32, 8, 128), dtype=torch.bfloat16)
        table = torch.empty((2, 4), dtype=torch.int32)
        start = torch.empty((2,), dtype=torch.int32)
        with fake.recording(Rec()) as rec:
            paged_kv_write(pool, k, k, table, start=start)
    rows = 2 * 32 * 8
    # k and v bf16, the (2, 4) int32 table and the starts read; codes and
    # four bf16 scales a row written, for K and V
    assert rec.ops == [("paged_kv_write", 2.0 * rows * 128,
                        2 * rows * 128 * 2 + 2 * 4 * 4 + 2 * 4
                        + 2 * rows * (128 + 4 * 2))]


def test_dry_run_counts_the_write_once_a_layer(tmp_path):
    """The paged decode loop of reduced qwen2 in the dry run: one write a
    layer, each with the bytes of one decode write."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-0.5b").reduced()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = tmp_path / "records"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
         str(out), "--arch", "qwen2-0.5b", "--shape", "decode_32k",
         "--reduced", "--mesh", "1x1", "--paged", "--quantized-kv",
         "--global-batch", "2", "--seq-len", "64"], capture_output=True,
        text=True, env=env, timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    (path,) = out.glob("*.json")
    with open(path) as f:
        kernels = json.load(f)["kernels"]
    from repro_torch.launch.specs import paged_cache_specs
    got = kernels["paged_kv_write"]
    kh, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    n_cols = paged_cache_specs(cfg, 2, 64)["page_table"].shape[1]
    assert got["calls"] == cfg.n_layers \
        == kernels["paged_flash_decode"]["calls"]
    rows = 2 * kh
    # k, v bf16, the int32 page table and positions read; codes and one
    # bf16 scale a row written
    per_call = 2 * rows * dh * 2 + 2 * n_cols * 4 + 2 * 4 \
        + 2 * rows * (dh + 2)
    assert got["bytes"] == cfg.n_layers * per_call
    assert got["flops"] == cfg.n_layers * 2.0 * rows * dh


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _both(pool, k, v, table, positions=None, start=None):
    """(kernel pool, plain pool) after the same write on the card; the
    kernel launched once."""
    want = _clone(pool)
    paged_kv_write_plain(want, k, v, table, positions, start)
    launches = paged_kv_write.launches
    paged_kv_write(pool, k, v, table, positions=positions, start=start)
    torch.cuda.synchronize()
    assert paged_kv_write.launches == launches + 1
    return pool, want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh,gs", [(128, 1), (128, 16), (128, 4), (64, 1),
                                   (64, 32), (256, 1), (256, 2), (320, 1),
                                   (512, 8), (40, 5)])
def test_card_bitwise_plain(cuda, dtype, dh, gs):
    """Decode at the cell's batch (B 128, Kh 8) and a 256-token chunk on
    pages of 128, every shape bitwise the plain version on the card."""
    pool, k, v, table, pos = _decode_case(128, 8, dh, gs, 128, 300, 2,
                                          dtype, 10, cuda)
    _assert_pools_equal(*_both(pool, k, v, table, positions=pos))
    pool, k, v, table, start = _chunk_case(1, 256, 8, dh, gs, 128, 20, 16,
                                           [512], dtype, 11, cuda)
    _assert_pools_equal(*_both(pool, k, v, table, start=start))


def test_card_parked_rows_and_pad_blocks(cuda):
    """Parked decode rows all write page 0 slot 0, and a chunk's blocks
    past the table page 0; every other page is bitwise the plain
    version's."""
    pool, k, v, table, pos = _decode_case(128, 8, 128, 1, 128, 300, 2,
                                          torch.bfloat16, 12, cuda,
                                          parked=range(0, 128, 3))
    _assert_pools_equal(*_both(pool, k, v, table, positions=pos),
                        parking=False)
    pool, k, v, table, start = _chunk_case(2, 512, 8, 128, 1, 128, 40, 6,
                                           [0, 384], torch.bfloat16, 13, cuda)
    _assert_pools_equal(*_both(pool, k, v, table, start=start),
                        parking=False)


def _chunk_of_rows(x, dh, device):
    """(1, C, 1, dh) chunk of the given rows on pages of 128 slots, each
    request page its own, and a fresh pool."""
    c = x.shape[0]
    pad = (-c) % 128
    x = torch.cat([x, torch.zeros((pad, dh), dtype=x.dtype)])
    n = x.shape[0] // 128
    table = torch.arange(1, n + 1, dtype=torch.int32)[None].to(device)
    start = torch.zeros((1,), dtype=torch.int32, device=device)
    x = x[None, :, None].to(device)
    return x, table, start, n + 1


def _check_rows(x, dh, gs, device):
    x, table, start, n_pages = _chunk_of_rows(x, dh, device)
    pool = _pool(n_pages, 128, 1, dh, gs, 14, device)
    got, want = _both(pool, x, x.flip(-1), table, start=start)
    _assert_pools_equal(got, want)
    return got


def _specials(dtype):
    f = torch.finfo(dtype)
    vals = [float("nan"), float("inf"), -float("inf"), 0.0, -0.0,
            f.tiny, -f.tiny, f.tiny / 2, f.tiny / 64, f.smallest_normal * 3,
            f.max, -f.max, 1.0, -1.0, 64.0, 1e-30, 2.0 ** -99]
    return torch.tensor(vals, dtype=torch.float32).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("gs", [1, 16])
def test_card_special_values(cuda, dtype, gs):
    """NaN, +-Inf, +-0, subnormals and the extremes, alone in a row, in a
    group of ordinary values and in all-zero groups."""
    dh = 128
    sp = _specials(dtype)
    rows = [torch.zeros(dh, dtype=dtype)]                 # a zero row
    rng = np.random.default_rng(15)
    for s in sp:
        base = torch.from_numpy(rng.normal(size=dh).astype(np.float32))
        for scale in (2.0 ** -140, 1.0, 2.0 ** 120):
            r = (base * scale).to(dtype)
            r[rng.integers(0, dh)] = s
            rows.append(r)
        z = torch.zeros(dh, dtype=dtype)
        z[rng.integers(0, dh)] = s                        # one value, zeros
        rows.append(z)
        rows.append(torch.full((dh,), float(s), dtype=dtype))
    got = _check_rows(torch.stack(rows), dh, gs, cuda)
    if gs == 1:     # row 2: ordinary values and one NaN
        assert torch.isnan(got["k_scale"][1, 2, 0, 0].float())
        assert (got["k_codes"][1, 2, 0] == 0x80).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_posit8_boundaries_and_ties(cuda, dtype):
    """Rows whose absmax is 64 * 2^j (scale 2^j): every posit8 value,
    each midpoint between neighbours (a tie, to the even code), a float
    either side of it, and values below minpos, scaled by 2^j."""
    from repro_torch.core import formats as fmt
    vals = np.asarray(fmt.code_values(fmt.POSIT8), dtype=np.float64)
    vals = np.unique(vals[np.isfinite(vals)])
    mids = (vals[1:] + vals[:-1]) / 2
    f32 = np.float32
    cand = np.concatenate([
        vals, mids, np.nextafter(mids.astype(f32), f32(np.inf)),
        np.nextafter(mids.astype(f32), f32(-np.inf)),
        [2.0 ** -7, 2.0 ** -12, 2.0 ** -30, -2.0 ** -9]]).astype(f32)
    cand = cand[np.abs(cand) <= 64]
    dh = 128
    rows = []
    for j in (-40, -3, 0, 5, 60):
        x = torch.from_numpy(cand * f32(2.0 ** j)).to(dtype)
        for at in range(0, len(x), dh - 1):
            r = torch.zeros(dh, dtype=dtype)
            part = x[at:at + dh - 1]
            r[:len(part)] = part
            r[-1] = 64.0 * 2.0 ** j
            rows.append(r)
    _check_rows(torch.stack(rows), dh, 1, cuda)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_every_bf16_magnitude_through_the_scale(cuda, dtype):
    """Each of the 2^15 non-negative bfloat16 bit patterns (zero,
    subnormals, normals, Inf, NaNs) as the absmax of a 64-column row of
    smaller values; in float32 also the floats one ulp either side."""
    bits = torch.arange(0, 1 << 15, dtype=torch.int32).to(torch.int16)
    mags = bits.view(torch.bfloat16).float()
    if dtype == torch.float32:
        up = torch.nextafter(mags, torch.tensor(float("inf")))
        down = torch.nextafter(mags, torch.tensor(0.0))
        mags = torch.cat([mags, up, down])
    dh = 64
    gen = torch.Generator().manual_seed(16)
    u = torch.rand((mags.shape[0], dh), generator=gen) * 2 - 1
    x = (u * mags[:, None]).to(dtype)
    x[torch.arange(x.shape[0]),
      torch.randint(0, dh, (x.shape[0],), generator=gen)] = mags.to(dtype)
    _check_rows(x, dh, 1, cuda)


def test_card_refuses_what_the_kernel_does_not_take(cuda):
    """A shape the kernel does not take (group 48 of Dh 96), float16
    rows, or a page table left on the host raise on the card, launching
    nothing and writing nothing."""
    pool, k, v, table, pos = _decode_case(8, 2, 96, 2, 16, 40, 2,
                                          torch.bfloat16, 17, cuda)
    want = _clone(pool)
    launches = paged_kv_write.launches
    with pytest.raises(ValueError, match="group of 48"):
        paged_kv_write(pool, k, v, table, positions=pos)
    pool128, k128, v128, table128, pos128 = _decode_case(
        8, 2, 128, 1, 16, 40, 2, torch.bfloat16, 17, cuda)
    want128 = _clone(pool128)
    with pytest.raises(ValueError, match="both bfloat16"):
        paged_kv_write(pool128, k128.half(), v128.half(), table128,
                       positions=pos128)
    with pytest.raises(ValueError, match="int32 with unit stride on cuda"):
        paged_kv_write(pool128, k128, v128, table128.cpu(),
                       positions=pos128)
    torch.cuda.synchronize()
    assert paged_kv_write.launches == launches
    _assert_pools_equal(pool, want)
    _assert_pools_equal(pool128, want128)


def _engine_reqs(vocab):
    rng = np.random.default_rng(18)
    pre = rng.integers(0, vocab, 40).astype(np.int32)
    reqs = []
    for i, (n, new) in enumerate([(10, 30), (3, 20), (24, 28), (12, 12),
                                  (40, 7), (9, 10), (6, 25), (30, 5)]):
        prompt = rng.integers(0, vocab, n).astype(np.int32)
        if i % 2:
            prompt = np.concatenate([pre, prompt])[:96 - new]
        reqs.append((prompt, new))
    return reqs


def _serve(make, reqs):
    eng = make()
    rids = [eng.submit(p, g) for p, g in reqs]
    out = eng.run()
    return [np.asarray(out[r]) for r in rids], eng


def _pools(eng):
    pools = [eng.pool] if hasattr(eng, "pool") else [eng.prefill.pool,
                                                     eng.decode.pool]
    return [{key: getattr(p, key) for key in KEYS} for p in pools]


@pytest.fixture
def engine_setup(cuda):
    from repro_torch.configs import get_config
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.models import zoo
    cfg = get_config("qwen2-0.5b").reduced()
    params = zoo.init_model(cfg, torch.Generator("cuda").manual_seed(0),
                            policy=PrecisionPolicy.paper_mixed())
    return cfg, params, _engine_reqs(cfg.vocab)


def test_card_one_launch_a_layer_and_forward(engine_setup):
    """Reduced qwen2 through ContinuousEngine on the pages context: the
    write launches once a layer for each decode iteration and each chunk
    (as often as the paged attention kernels)."""
    from repro_torch.kernels.flash_decode import (paged_flash_decode,
                                                  paged_flash_prefill)
    from repro_torch.serve.engine import ContinuousEngine
    cfg, params, reqs = engine_setup
    before = (paged_kv_write.launches,
              paged_flash_decode.launches + paged_flash_prefill.launches)
    _serve(lambda: ContinuousEngine(
        cfg, params, n_pages=40, page_size=16, max_batch=4, max_len=96,
        prefill_chunk_tokens=32, prefill_context="pages",
        prefix_cache=True, decode_steps=2, device="cuda"), reqs)
    attn = paged_flash_decode.launches + paged_flash_prefill.launches \
        - before[1]
    assert attn > 0 and attn % cfg.n_layers == 0
    assert paged_kv_write.launches - before[0] == attn


@pytest.mark.parametrize("engine", ["continuous", "disagg"])
def test_card_engines_equal_with_plain_write_forced(engine_setup,
                                                    monkeypatch, engine):
    """The same tokens and byte-equal pools (but the parking page) with
    the kernel and with the plain version forced on the card."""
    from repro_torch.models import attention
    from repro_torch.serve.disagg import DisaggEngine
    from repro_torch.serve.engine import ContinuousEngine
    cfg, params, reqs = engine_setup
    kw = dict(page_size=16, max_batch=4, max_len=96,
              prefill_chunk_tokens=32, prefill_context="pages",
              prefix_cache=True, decode_steps=2)
    if engine == "continuous":
        def make():
            return ContinuousEngine(cfg, params, n_pages=40, device="cuda",
                                    **kw)
    else:
        def make():
            return DisaggEngine(cfg, params, prefill_pages=40,
                                decode_pages=40, prefill_device="cuda",
                                decode_device="cuda", **kw)
    launches = paged_kv_write.launches
    toks, eng = _serve(make, reqs)
    assert paged_kv_write.launches > launches
    with monkeypatch.context() as m:
        m.setattr(attention, "_pool_write", paged_kv_write_plain)
        launches = paged_kv_write.launches
        toks_plain, eng_plain = _serve(make, reqs)
        assert paged_kv_write.launches == launches
    for a, b in zip(toks, toks_plain):
        np.testing.assert_array_equal(a, b)
    for got, want in zip(_pools(eng), _pools(eng_plain)):
        for key in KEYS:
            a, b = got[key][:, 1:], want[key][:, 1:]
            if key.endswith("scale"):
                a, b = a.view(torch.int16), b.view(torch.int16)
            assert torch.equal(a, b), key
