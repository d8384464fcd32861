"""K2: Brent-Luk scalar-Jacobi rotations of a batch of symmetric pivot blocks.

Port of `kronfluence_tpu/ops/pallas/jacobi.py:jacobi_pivot_rotations`. For a
(Y, m, m) fp32 batch of symmetric blocks (m even, at least 4) it runs
`sweeps * (m - 1)` rounds of parallel Jacobi rotations. A round pairs the
adjacent seats (2k, 2k+1), rotates rows then columns with Rutishauser's
coefficients, and applies the Brent-Luk seat exchange to A and to V's
columns. It returns V, orthogonal with V^T S V approximately diagonal, in the
JAX kernel's column layout.

`jacobi_pivot_rotations` launches a CUDA kernel for a CUDA tensor and takes
the plain version `jacobi_pivot_rotations_reference` only for a CPU tensor;
for a CUDA tensor it launches the kernel that `jacobi_route(m)` names or
raises. Routes: "registers" (`csrc/jacobi_m64.cu`, m = 64, the blocked
solver's default pivot block: A and V held in registers) and "generic"
(`csrc/jacobi.cu`, every other even m up to 128: A and V in shared memory).
`jacobi_pivot_rotations.launches` counts the launches of both,
`.registers_launches` and `.generic_launches` those of each route.

One deliberate difference from the JAX kernel: it computes each side of a
pair's rotation separately, and when the pair's two diagonal entries are
exactly equal both sides get the same sign of s, so V becomes singular
(orthogonality error ~1 for a block with one exact tie). Here the pair's
coefficients are computed once and the odd seat takes -s, which is the JAX
kernel's result whenever the diagonal entries differ.
"""

import ctypes
import functools

import numpy as np
import torch

from kronfluence_tpu_torch.ops.kernels.build import check_launch, load_library

_EPS = float(np.finfo(np.float32).eps)
# A and V of one block live in the shared memory of one CTA (2 m^2 fp32).
MAX_M = 128
# The block size of the register kernel: one lane a seat pair.
REGISTERS_M = 64


def jacobi_route(m: int) -> str:
    """The CUDA kernel that takes (Y, m, m) blocks: "registers" at m = 64,
    "generic" otherwise."""
    return "registers" if m == REGISTERS_M else "generic"


def _seat_source(i: int, m: int) -> int:
    """Brent-Luk seat exchange: after a round, seat i holds what seat
    sigma(i) held (`kronfluence_tpu/ops/pallas/jacobi.py:81-101`)."""
    if i == 0:
        return 0
    if i == 2 or i == m - 1:
        return i - 1
    return i + 2 if i % 2 else i - 2


@functools.lru_cache(maxsize=None)
def _round_tables(m: int):
    """Flat (m * m) gather indices of the row-partner swap, the column-partner
    swap and the seat exchange of both axes, and the per-seat sign of s."""
    sigma = np.asarray([_seat_source(i, m) for i in range(m)], np.int64)
    partner = np.arange(m, dtype=np.int64) ^ 1
    idx = np.arange(m, dtype=np.int64)
    rows = (partner[:, None] * m + idx[None, :]).reshape(-1)
    cols = (idx[:, None] * m + partner[None, :]).reshape(-1)
    seats = (sigma[:, None] * m + sigma[None, :]).reshape(-1)
    col_seats = (idx[:, None] * m + sigma[None, :]).reshape(-1)
    sign = np.tile(np.asarray([1.0, -1.0], np.float32), m // 2)
    return rows, cols, seats, col_seats, sign


def _check_shape(s: torch.Tensor) -> None:
    if s.dim() != 3 or s.shape[1] != s.shape[2]:
        raise ValueError(f"jacobi_pivot_rotations takes (Y, m, m) blocks; got {tuple(s.shape)}.")
    m = s.shape[1]
    if m % 2 or m < 4:
        raise ValueError(f"jacobi_pivot_rotations takes an even block size m >= 4; got {m}.")


def rotation_coefficients(a_pp, a_qq, a_pq, eps: float):
    """Rutishauser's (c, s) zeroing a_pq, with the `eps * scale` skip and
    c = rsqrt(1 + t^2) (`_rotation_coeffs`, jacobi.py:45-63)."""
    denom = 2.0 * a_pq
    tau = (a_qq - a_pp) / torch.where(denom == 0.0, torch.ones_like(denom), denom)
    sign_tau = torch.where(tau >= 0.0, 1.0, -1.0)
    t = sign_tau / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    scale = torch.sqrt((a_pp * a_qq).abs()) + a_pp.abs() + a_qq.abs()
    t = torch.where(a_pq.abs() > eps * scale, t, torch.zeros_like(t))
    c = torch.rsqrt(1.0 + t * t)
    return c, t * c


def jacobi_pivot_rotations_reference(s: torch.Tensor, sweeps: int, eps=None) -> torch.Tensor:
    """The plain PyTorch version: the JAX kernel's rounds on the whole batch,
    with the seats moved by gathers. fp32, or fp64 for fp64 blocks (which
    shows how far fp32 rounding alone moves V)."""
    _check_shape(s)
    eps = _EPS if eps is None else float(eps)
    y, m, _ = s.shape
    dtype = torch.float64 if s.dtype == torch.float64 else torch.float32
    rows, cols, seats, col_seats, sign = (
        torch.from_numpy(t).to(s.device) for t in _round_tables(m)
    )
    sign = sign.to(dtype)
    a = s.to(dtype).reshape(y, m, m)
    v = torch.eye(m, dtype=dtype, device=s.device).expand(y, m, m)

    def gather(x, flat):  # x[:, i, j] -> x.flat[:, flat[i * m + j]]
        return x.reshape(y, m * m).index_select(1, flat).view(y, m, m)

    for _ in range(sweeps * (m - 1)):
        d = a.diagonal(dim1=1, dim2=2)
        c, sn = rotation_coefficients(d[:, 0::2], d[:, 1::2], a[:, 0::2, 1::2].diagonal(dim1=1, dim2=2), eps)
        c = c.repeat_interleave(2, dim=1)
        sn = sn.repeat_interleave(2, dim=1) * sign
        # new_i = c_i * old_i - s_i * old_partner(i); the odd seat has -s.
        a = c[:, :, None] * a - sn[:, :, None] * gather(a, rows)
        a = c[:, None, :] * a - sn[:, None, :] * gather(a, cols)
        a = gather(a, seats)
        v = c[:, None, :] * v - sn[:, None, :] * gather(v, cols)
        v = gather(v, col_seats)
    return v.contiguous()


def _check_cuda_operand(s: torch.Tensor) -> None:
    if s.device.type != "cuda":
        raise ValueError(
            f"jacobi_pivot_rotations takes a CPU or CUDA tensor; got device {s.device}."
        )
    if s.dtype != torch.float32:
        raise TypeError(f"jacobi_pivot_rotations takes fp32 blocks; got {s.dtype}.")
    if not s.is_contiguous():
        raise ValueError("jacobi_pivot_rotations takes contiguous blocks.")
    if s.shape[1] > MAX_M:
        raise ValueError(
            f"the CUDA kernel holds a block in shared memory: m <= {MAX_M}; got {s.shape[1]}."
        )
    if s.shape[0] == 0:
        raise ValueError("jacobi_pivot_rotations takes a non-empty batch.")


def jacobi_pivot_rotations(s: torch.Tensor, sweeps: int, eps=None) -> torch.Tensor:
    """Diagonalizing rotations V (Y, m, m) of symmetric blocks s (Y, m, m).

    CUDA: fp32 contiguous blocks, m even in [4, 128], via the kernel of
    `jacobi_route(m)`.
    CPU: the plain version. `eps` (the rotation threshold) defaults to fp32
    machine epsilon.
    """
    _check_shape(s)
    if s.device.type == "cpu":
        return jacobi_pivot_rotations_reference(s, sweeps, eps)
    _check_cuda_operand(s)
    eps = _EPS if eps is None else float(eps)
    y, m, _ = s.shape
    route = jacobi_route(m)
    with torch.cuda.device(s.device):
        lib = load_library()
        v = torch.empty_like(s)
        stream = torch.cuda.current_stream(s.device).cuda_stream
        if route == "registers":
            err = lib.kf_jacobi_pivot_rotations_m64(
                s.data_ptr(), v.data_ptr(), y, sweeps, ctypes.c_float(eps), stream
            )
        else:
            err = lib.kf_jacobi_pivot_rotations(
                s.data_ptr(), v.data_ptr(), y, m, sweeps, ctypes.c_float(eps), stream
            )
        check_launch(err, f"jacobi ({route})")
    jacobi_pivot_rotations.launches += 1
    if route == "registers":
        jacobi_pivot_rotations.registers_launches += 1
    else:
        jacobi_pivot_rotations.generic_launches += 1
    return v


jacobi_pivot_rotations.launches = 0
jacobi_pivot_rotations.registers_launches = 0
jacobi_pivot_rotations.generic_launches = 0
