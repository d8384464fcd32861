"""K1: `flat^T @ flat` over lower-triangle tiles, hand-written for Hopper.

Port of `kronfluence_tpu/ops/pallas/syrk.py`. The CUDA kernels
(`csrc/syrk.cu`) compute only the lower-triangle output tiles and write each
tile and its mirror from one set of fp32 sums, so the result is exactly
symmetric. `syrk` launches one for a CUDA tensor and takes the plain version
`syrk_reference` only for a CPU tensor; for a CUDA tensor it launches a
kernel or raises. A 16-bit operand (bf16 or fp16) goes to the wgmma kernel
fed by TMA when `bf16_route` says TMA can describe it, else to the wmma
kernel, each built for its type; fp32 to the FMA kernel. `syrk.launches`
counts every launch, `syrk.wgmma_launches` the launches of the wgmma kernel
and `syrk.f16_launches` those on fp16 operands.
"""

import numpy as np
import torch

from kronfluence_tpu_torch.ops.kernels.build import check_launch, load_library
from kronfluence_tpu_torch.utils.dtypes import resolve_dtype

# The JAX package's shape rule (kronfluence_tpu/ops/pallas/syrk.py:74-79),
# kept as it is: fp32 accumulation and at least 4 column tiles of 512. Below
# that the triangle saves too little over one full product.
_TILE_N = 512
_MIN_TILES = 4


# Output tile edge of the CUDA kernels' bf16 triangle (`csrc/syrk.cu:kTile`).
TILE = 128


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
    """CTAs of one bf16 launch at width n: the lower triangle's tiles."""
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
        else:
            vec = int(flat.data_ptr() % 16 == 0 and n % 4 == 0)
            err = lib.kf_syrk_f32(flat.data_ptr(), out.data_ptr(), rows, n, vec, stream)
        check_launch(err, "syrk")
    syrk.launches += 1
    syrk.wgmma_launches += wgmma
    syrk.f16_launches += flat.dtype == torch.float16
    return out


syrk.launches = 0
syrk.wgmma_launches = 0
syrk.f16_launches = 0
