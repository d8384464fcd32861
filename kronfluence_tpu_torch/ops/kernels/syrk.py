"""K1: `flat^T @ flat` over lower-triangle tiles, hand-written for Hopper.

Port of `kronfluence_tpu/ops/pallas/syrk.py`. The CUDA kernel
(`csrc/syrk.cu`) computes only the lower-triangle output tiles and writes each
tile and its mirror from one set of fp32 sums, so the result is exactly
symmetric. `syrk` launches it for a CUDA tensor and takes the plain version
`syrk_reference` only for a CPU tensor; for a CUDA tensor it launches the
kernel or raises. `syrk.launches` counts the kernel's launches.
"""

import torch

from kronfluence_tpu_torch.ops.kernels.build import check_launch, load_library
from kronfluence_tpu_torch.utils.dtypes import resolve_dtype

# The JAX package's shape rule (kronfluence_tpu/ops/pallas/syrk.py:74-79),
# kept as it is: fp32 accumulation and at least 4 column tiles of 512. Below
# that the triangle saves too little over one full product.
_TILE_N = 512
_MIN_TILES = 4


def _round_up(value: int, gran: int) -> int:
    return -(-value // gran) * gran


def syrk_supported(n: int, accum_dtype, tile_n: int = _TILE_N) -> bool:
    """Whether `gram` routes a width-`n` operand through the triangle kernel."""
    return (
        resolve_dtype(accum_dtype) == torch.float32
        and _round_up(n, tile_n) // tile_n >= _MIN_TILES
    )


def syrk_reference(flat: torch.Tensor, accum_dtype=torch.float32) -> torch.Tensor:
    """The plain PyTorch version: the full product in the accumulation dtype."""
    acc = flat.to(resolve_dtype(accum_dtype))
    return acc.T @ acc


def _check_cuda_operand(flat: torch.Tensor, accum_dtype) -> None:
    if flat.device.type != "cuda":
        raise ValueError(f"syrk takes a CPU or CUDA tensor; got device {flat.device}.")
    if flat.dim() != 2:
        raise ValueError(f"syrk takes a 2-D (rows, n) operand; got shape {tuple(flat.shape)}.")
    if flat.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"syrk takes bf16 or fp32 operands; got {flat.dtype}.")
    if resolve_dtype(accum_dtype) != torch.float32:
        raise TypeError(f"syrk accumulates and returns fp32; got accum_dtype {accum_dtype}.")
    if not flat.is_contiguous():
        raise ValueError("syrk takes a contiguous (row-major) operand.")
    if flat.shape[0] == 0 or flat.shape[1] == 0:
        raise ValueError(f"syrk takes a non-empty operand; got shape {tuple(flat.shape)}.")


def syrk(flat: torch.Tensor, accum_dtype=torch.float32) -> torch.Tensor:
    """Returns the symmetric (n, n) `flat^T @ flat` of a (rows, n) operand.

    CUDA: bf16 or fp32 operand, fp32 result, via the hand-written kernel.
    CPU: the plain version, in `accum_dtype`.
    """
    if flat.device.type == "cpu":
        return syrk_reference(flat, accum_dtype)
    _check_cuda_operand(flat, accum_dtype)
    rows, n = flat.shape
    with torch.cuda.device(flat.device):
        lib = load_library()
        out = torch.empty((n, n), dtype=torch.float32, device=flat.device)
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        aligned = flat.data_ptr() % 16 == 0
        if flat.dtype == torch.bfloat16:
            vec = int(aligned and n % 8 == 0)
            err = lib.kf_syrk_bf16(flat.data_ptr(), out.data_ptr(), rows, n, vec, stream)
        else:
            vec = int(aligned and n % 4 == 0)
            err = lib.kf_syrk_f32(flat.data_ptr(), out.data_ptr(), rows, n, vec, stream)
        check_launch(err, "syrk")
    syrk.launches += 1
    return out


syrk.launches = 0
