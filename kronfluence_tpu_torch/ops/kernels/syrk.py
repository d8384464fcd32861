"""K1: `flat^T @ flat` over lower-triangle tiles, hand-written for Hopper.

Port of `kronfluence_tpu/ops/pallas/syrk.py`. The CUDA kernels
(`csrc/syrk.cu`) compute only the lower-triangle output tiles and write each
tile and its mirror from one set of fp32 sums, so the result is exactly
symmetric. `syrk` launches one for a CUDA tensor and takes the plain version
`syrk_reference` only for a CPU tensor; for a CUDA tensor it launches a
kernel or raises. A 16-bit operand (bf16 or fp16) goes to the wgmma kernel
fed by TMA when `bf16_route` says TMA can describe it, else to the wmma
kernel, each built for its type; fp32 to the FFMA ring kernel, on the rows
`f32_plan` splits for the card (then a second kernel sums the partial tiles
in a fixed order). `syrk.launches` counts every gram, `syrk.wgmma_launches`
the launches of the wgmma kernel, `syrk.f16_launches` those on fp16
operands and `syrk.f32_reduce_launches` the fp32 route's reductions.
"""

from typing import NamedTuple

import numpy as np
import torch

from kronfluence_tpu_torch.ops.kernels.build import check_launch, load_library
from kronfluence_tpu_torch.utils.dtypes import resolve_dtype

# The JAX package's shape rule (kronfluence_tpu/ops/pallas/syrk.py:74-79),
# kept as it is: fp32 accumulation and at least 4 column tiles of 512. Below
# that the triangle saves too little over one full product.
_TILE_N = 512
_MIN_TILES = 4


# Output tile edge of the CUDA kernels' triangle (`csrc/syrk.cu:kTile`).
TILE = 128

# The fp32 kernel's schedule (`f32_plan`). Rows go through the ring in slabs
# of F32_SLAB (`csrc/syrk.cu:kSlabF`); a split cuts them into at most
# F32_MAX_SPLITS ranges of whole slabs, each at least F32_MIN_RANGE_ROWS,
# with at most F32_MAX_PARTIALS partial tiles of 64 KB (256 MiB) in all.
F32_SLAB = 16
F32_MIN_RANGE_ROWS = 256
F32_MAX_SPLITS = 8
F32_MAX_PARTIALS = 4096
# SMs of an H100 SXM: the plan's default card.
H100_SMS = 132
# The plan's cost model, in rows of one 128 x 128 tile on one SM (about
# 0.1 us at 60% of the SM's fp32 peak): a CTA's ring fill and epilogue; one
# partial tile written and read back (128 KB at 3.35 TB/s is 39 ns of the
# whole card); the reduction's launch.
F32_CTA_ROWS = 32
F32_PARTIAL_ROWS = 0.4
F32_REDUCE_ROWS = 48


class F32Plan(NamedTuple):
    """The fp32 kernel's grid: `tiles` lower-triangle tiles of `tile`, each
    over `splits` row ranges of `span` rows (the last may be shorter)."""

    tile: int
    tiles: int
    splits: int
    span: int
    ranges: tuple


def f32_plan(rows: int, n: int, sms: int = H100_SMS) -> F32Plan:
    """The row split of the fp32 kernel on a card of `sms` SMs.

    CTA (p, r) computes tile `tile_pair(p)` over rows `ranges[r]`. The split
    is the one whose waves (CTAs over SMs, rounded up) times the range's
    rows, plus the partials' traffic and the reduction's launch, cost least:
    136 tiles at n 2048 or 171 at 2304 leave most of 132 SMs with one tile
    while a few run two, unless the rows are split. Ties keep fewer splits.
    A plain function of the shape and the card, so two calls plan alike."""
    if rows <= 0 or n <= 0:
        raise ValueError(f"f32_plan takes a non-empty (rows, n); got ({rows}, {n}).")
    tiles = triangle_tiles(n, TILE)
    best = None
    for want in range(1, F32_MAX_SPLITS + 1):
        span = _round_up(-(-rows // want), F32_SLAB)
        splits = -(-rows // span)
        if splits > 1 and (rows - (splits - 1) * span < F32_MIN_RANGE_ROWS
                           or tiles * splits > F32_MAX_PARTIALS):
            continue  # the last range, the shortest, is too short, or too many partials
        waves = -(-tiles * splits // sms)
        cost = waves * (span + F32_CTA_ROWS)
        if splits > 1:
            cost += tiles * splits * F32_PARTIAL_ROWS + F32_REDUCE_ROWS
        if best is None or cost < best[0]:
            best = (cost, splits, span)
    _, splits, span = best
    ranges = tuple((r * span, min(rows, (r + 1) * span)) for r in range(splits))
    return F32Plan(TILE, tiles, splits, span, ranges)


def _round_up(value: int, gran: int) -> int:
    return -(-value // gran) * gran


def syrk_supported(n: int, accum_dtype, tile_n: int = _TILE_N) -> bool:
    """Whether `gram` routes a width-`n` operand through the triangle kernel."""
    return (
        resolve_dtype(accum_dtype) == torch.float32
        and _round_up(n, tile_n) // tile_n >= _MIN_TILES
    )


def bf16_route(n: int, data_ptr: int) -> str:
    """The kernel a contiguous 16-bit (bf16 or fp16) (rows, n) operand at
    `data_ptr` takes:
    "wgmma" when a TMA tensor map can describe it (a row stride of whole
    16-byte units, so n % 8 == 0, and a 16-byte aligned base), else "wmma"."""
    return "wgmma" if n % 8 == 0 and data_ptr % 16 == 0 else "wmma"


def tile_pair(p: int) -> tuple:
    """The (i, j <= i) lower-triangle tile of CTA `p`, computed as the kernels'
    `tile_pair` computes it (fp32 square root, then exact integer steps)."""
    f32 = np.float32
    i = int((np.sqrt(f32(8) * f32(p) + f32(1)) - f32(1)) * f32(0.5))
    while i > 0 and i * (i + 1) // 2 > p:
        i -= 1
    while (i + 1) * (i + 2) // 2 <= p:
        i += 1
    return i, p - i * (i + 1) // 2


def triangle_tiles(n: int, tile: int = TILE) -> int:
    """The lower triangle's tiles at width n: the CTAs of one launch (of
    each row range on the fp32 route)."""
    t = -(-n // tile)
    return t * (t + 1) // 2


def wgmma_smem_bytes() -> int:
    """Dynamic shared memory of one CTA of the wgmma kernel (builds and loads
    the kernels on first use)."""
    return int(load_library().kf_syrk_bf16_wgmma_smem_bytes())


def syrk_reference(flat: torch.Tensor, accum_dtype=torch.float32) -> torch.Tensor:
    """The plain PyTorch version: the full product in the accumulation dtype."""
    acc = flat.to(resolve_dtype(accum_dtype))
    return acc.T @ acc


def _check_cuda_operand(flat: torch.Tensor, accum_dtype) -> None:
    if flat.device.type != "cuda":
        raise ValueError(f"syrk takes a CPU or CUDA tensor; got device {flat.device}.")
    if flat.dim() != 2:
        raise ValueError(f"syrk takes a 2-D (rows, n) operand; got shape {tuple(flat.shape)}.")
    if flat.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"syrk takes bf16, fp16 or fp32 operands; got {flat.dtype}.")
    if resolve_dtype(accum_dtype) != torch.float32:
        raise TypeError(f"syrk accumulates and returns fp32; got accum_dtype {accum_dtype}.")
    if not flat.is_contiguous():
        raise ValueError("syrk takes a contiguous (row-major) operand.")
    if flat.shape[0] == 0 or flat.shape[1] == 0:
        raise ValueError(f"syrk takes a non-empty operand; got shape {tuple(flat.shape)}.")


def _launch_f32(lib, flat: torch.Tensor, out: torch.Tensor, stream: int) -> None:
    """The fp32 ring kernel on `f32_plan`'s split for this card, then, over
    several ranges, the reduction of their partial tiles (a workspace of
    tiles x splits x 64 KB)."""
    rows, n = flat.shape
    plan = f32_plan(rows, n, torch.cuda.get_device_properties(flat.device).multi_processor_count)
    vec = int(flat.data_ptr() % 16 == 0 and n % 4 == 0)
    partial = None
    if plan.splits > 1:
        partial = torch.empty((plan.tiles * plan.splits, TILE * TILE), dtype=torch.float32,
                              device=flat.device)
    err = lib.kf_syrk_f32(flat.data_ptr(), out.data_ptr(),
                          None if partial is None else partial.data_ptr(), rows, n, plan.span,
                          plan.splits, vec, stream)
    check_launch(err, "syrk")
    if partial is not None:
        check_launch(lib.kf_syrk_f32_reduce(partial.data_ptr(), out.data_ptr(), n, plan.splits,
                                            stream), "syrk's fp32 reduction")
        syrk.f32_reduce_launches += 1


def syrk(flat: torch.Tensor, accum_dtype=torch.float32) -> torch.Tensor:
    """Returns the symmetric (n, n) `flat^T @ flat` of a (rows, n) operand.

    CUDA: bf16, fp16 or fp32 operand, fp32 result, via the hand-written
    kernel. CPU: the plain version, in `accum_dtype`.
    """
    if flat.device.type == "cpu":
        return syrk_reference(flat, accum_dtype)
    _check_cuda_operand(flat, accum_dtype)
    rows, n = flat.shape
    with torch.cuda.device(flat.device):
        lib = load_library()
        out = torch.empty((n, n), dtype=torch.float32, device=flat.device)
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        wgmma = False
        if flat.dtype in (torch.bfloat16, torch.float16):
            wgmma = bf16_route(n, flat.data_ptr()) == "wgmma"
            launch = {
                (torch.bfloat16, True): lib.kf_syrk_bf16_wgmma,
                (torch.bfloat16, False): lib.kf_syrk_bf16,
                (torch.float16, True): lib.kf_syrk_f16_wgmma,
                (torch.float16, False): lib.kf_syrk_f16,
            }[flat.dtype, wgmma]
            err = launch(flat.data_ptr(), out.data_ptr(), rows, n, stream)
            check_launch(err, "syrk")
        else:
            _launch_f32(lib, flat, out, stream)
    syrk.launches += 1
    syrk.wgmma_launches += wgmma
    syrk.f16_launches += flat.dtype == torch.float16
    return out


syrk.launches = 0
syrk.wgmma_launches = 0
syrk.f16_launches = 0
syrk.f32_reduce_launches = 0
