"""K1's fp32 route: the plan of the ring kernel and the split it schedules.

`f32_plan` sets the fp32 kernel's grid (csrc/syrk.cu:syrk_f32_ring_kernel):
CTA (p, r) computes lower-triangle tile `tile_pair(p)` over row range r, and
over several ranges `syrk_f32_reduce_kernel` sums each tile's partials in
range order. These tests hold on the CPU that the grid covers every tile and
every row exactly once, and that a plain emulation of the split and its
fixed-order sum matches the plain version and, through it, the JAX Pallas
kernel (interpret mode). The `cuda`-marked cases hold the kernel itself on
the card; they skip here. The file imports JAX only inside the test that
compares with it, so that on the card, which has no JAX, `python -m pytest
--noconftest tests/test_torch_syrk_f32.py -m cuda` runs the card's cases.
"""

import numpy as np
import pytest
import torch

from kronfluence_tpu_torch.ops.kernels.syrk import (
    F32_MAX_PARTIALS,
    F32_MAX_SPLITS,
    F32_MIN_RANGE_ROWS,
    F32_SLAB,
    H100_SMS,
    TILE,
    f32_plan,
    syrk,
    syrk_reference,
    tile_pair,
    triangle_tiles,
)

# The shapes the card times (phase 4: GPT-2 small's grams at batch 16 x 512;
# phase 18: ResNet-50's stage-2 and stage-3 grams at batch 48 x 49 or x 196),
# phase 4's odd widths, and ragged ones: rows under one tile, widths just
# past the shape rule's 1536.
TIMED = [(8192, 2304), (8192, 3072), (2352, 2048), (2352, 4608), (9408, 2304)]
ODD = [(1000, 2000), (300, 1001), (777, 1539)]
RAGGED = [(5, 1537), (64, 1539), (127, 2001), (100, 1537), (4099, 1539), (2049, 2001)]
# A100 (108 SMs) and H100 PCIe (114) beside the H100 SXM's 132.
CARDS = [H100_SMS, 114, 108]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("sms", CARDS)
@pytest.mark.parametrize("rows,n", TIMED + ODD + RAGGED)
def test_f32_plan_covers_every_tile_and_row_once(rows, n, sms):
    plan = f32_plan(rows, n, sms)
    t = -(-n // TILE)
    assert plan.tile == TILE and plan.tiles == triangle_tiles(n) == t * (t + 1) // 2
    assert 1 <= plan.splits <= F32_MAX_SPLITS and len(plan.ranges) == plan.splits
    assert plan.span % F32_SLAB == 0 and plan.span * plan.splits >= rows
    # The ranges cut [0, rows) into contiguous pieces of `span` rows, the
    # last one shorter; split ranges hold a few hundred rows at least.
    assert plan.ranges[0][0] == 0 and plan.ranges[-1][1] == rows
    for r, (r0, r1) in enumerate(plan.ranges):
        assert r0 == r * plan.span and r0 < r1 <= r0 + plan.span
        if plan.splits > 1:
            assert r1 - r0 >= F32_MIN_RANGE_ROWS
    assert plan.splits == 1 or plan.tiles * plan.splits <= F32_MAX_PARTIALS
    # Each (tile, row) of the lower triangle once over the grid's CTAs.
    seen = {}
    for p in range(plan.tiles):
        i, j = tile_pair(p)
        for r0, r1 in plan.ranges:
            for row in (r0, r1 - 1):
                seen[(i, j, row)] = seen.get((i, j, row), 0) + 1
    tiles = {(i, j) for i, j, _ in seen}
    assert tiles == {(i, j) for i in range(t) for j in range(i + 1)}
    assert all(count == 1 for count in seen.values())
    covered = np.zeros(rows, dtype=np.int64)
    for r0, r1 in plan.ranges:
        covered[r0:r1] += 1
    assert (covered == 1).all()
    assert f32_plan(rows, n, sms) == plan


@pytest.mark.parametrize(
    "rows,n,splits",
    [
        # 171 and 136 tiles leave most of 132 SMs one tile and a few two:
        # the rows split.
        (8192, 2304, 3), (9408, 2304, 3), (2352, 2048, 7),
        # 300 and 666 tiles: 2.3 and 5.0 a SM, split for the last wave.
        (8192, 3072, 3), (2352, 4608, 3),
        # Fewer tiles than SMs: one range. Many tiles: no last wave to fill,
        # or a split would want more than F32_MAX_PARTIALS partial tiles.
        (777, 1539, 1), (15360, 14336, 1), (65536, 15105, 1),
        # Too few rows for two ranges of F32_MIN_RANGE_ROWS.
        (300, 1001, 1), (500, 2048, 1),
    ],
)
def test_f32_plan_splits_for_the_h100(rows, n, splits):
    """The splits the card runs at (PERF.md's K1 row records them)."""
    assert f32_plan(rows, n).splits == splits


def test_f32_plan_refuses_an_empty_operand():
    with pytest.raises(ValueError, match="non-empty"):
        f32_plan(0, 2048)


def split_emulation(flat: torch.Tensor, plan) -> torch.Tensor:
    """The plain form of the kernels' split: one fp32 partial product per row
    range, summed in range order, left to right, then the lower triangle
    mirrored onto the upper one."""
    total = None
    for r0, r1 in plan.ranges:
        part = flat[r0:r1].T @ flat[r0:r1]
        total = part if total is None else total + part
    return torch.tril(total) + torch.tril(total, -1).T


def _operand(rows, n, kind):
    a = np.random.default_rng(rows * 7 + n).standard_normal((rows, n)).astype(np.float32)
    return np.abs(a) if kind == "abs" else a


@pytest.mark.parametrize("kind", ["normal", "abs"])
@pytest.mark.parametrize(
    "rows,n,sms",
    [
        # SM counts that leave the last wave nearly empty, so the plan splits
        # at CPU-sized shapes: 15 tiles on 14 SMs, 6 on 5, 21 on 20.
        (1100, 640, 14), (1500, 300, 5), (2000, 700, 20),
    ],
)
def test_split_emulation_matches_plain_version_and_jax(rows, n, sms, kind):
    """The split's fp32 partials summed in a fixed order against the plain
    version within phase 4's limit (1e-4 max|C| + 1e-4 |C|: fp32 sums of the
    same products in another order), and against the JAX kernel within the
    JAX package's 5e-6 of max|C|; exactly symmetric, and the same bits twice."""
    jnp = pytest.importorskip("jax.numpy")
    jax_syrk = pytest.importorskip("kronfluence_tpu.ops.pallas.syrk").syrk
    plan = f32_plan(rows, n, sms)
    assert plan.splits > 1
    a = _operand(rows, n, kind)
    flat = torch.from_numpy(a)
    got = split_emulation(flat, plan)
    assert torch.equal(got, got.T)
    assert torch.equal(got, split_emulation(flat, plan))
    want = syrk_reference(flat, torch.float32)
    limit = 1e-4 * want.abs().max() + 1e-4 * want.abs()
    assert bool(((got - want).abs() <= limit).all())
    jax_c = np.asarray(jax_syrk(jnp.asarray(a), jnp.float32, tile_n=256, tile_k=256,
                                interpret=True))
    scale = np.abs(jax_c).max()
    np.testing.assert_allclose(got.numpy() / scale, jax_c / scale, atol=5e-6)


def test_cpu_fp32_operand_takes_the_plain_path_and_counts_nothing():
    a = torch.from_numpy(_operand(600, 1539, "normal"))
    before = (syrk.launches, syrk.f32_reduce_launches)
    assert torch.equal(syrk(a), syrk_reference(a))
    assert (syrk.launches, syrk.f32_reduce_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("rows,n", TIMED + ODD)
def test_cuda_f32_route_matches_plain_version(rows, n, offset):
    """Card only: the ring kernel (16-byte copies, or 4-byte copies from a
    base one float off 16 bytes) on the plan's split, within phase 4's limit
    of the plain version, exactly symmetric, the same bits on two calls, and
    one reduction a call exactly when the plan splits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain version only")
    gen = torch.Generator("cuda").manual_seed(rows + n)
    base = torch.randn(rows * n + 1, generator=gen, device="cuda")
    a = base[offset:offset + rows * n].view(rows, n)
    plan = f32_plan(rows, n, torch.cuda.get_device_properties(0).multi_processor_count)
    launches, reductions = syrk.launches, syrk.f32_reduce_launches
    got, again = syrk(a), syrk(a)
    want = syrk_reference(a)
    torch.cuda.synchronize()
    assert syrk.launches == launches + 2
    assert syrk.f32_reduce_launches == reductions + 2 * (plan.splits > 1)
    assert torch.equal(got, got.T)
    assert torch.equal(got, again)
    assert bool(((got - want).abs() <= 1e-4 * want.abs().max() + 1e-4 * want.abs()).all())
