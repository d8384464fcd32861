"""Low-rank compression of preconditioned query gradients.

Port of `kronfluence_tpu/ops/svd.py`. A batch of (q, o, i) gradients becomes
the pair (left (q, o, r), right (q, r, i)) with left @ right the rank-r
truncation. Library factorisations on the gradient's device
(`torch.linalg.svd`, `torch.linalg.qr`, cuSOLVER on the card), as the JAX
package runs XLA's: no hand kernel, and never a host copy.
"""

from typing import Any, Optional, Tuple

import torch

from kronfluence_tpu_torch.utils.dtypes import resolve_dtype


def goes_lowrank(d_in: int, d_out: int, score_args: Any) -> bool:
    """Whether the pairwise stage keeps a module's preconditioned query
    gradient of shape (d_out, d_in) as a low-rank pair: with
    `query_gradient_low_rank` below both dimensions, and never in an
    aggregated query block (one dense row)."""
    rank = score_args.query_gradient_low_rank
    return (rank is not None and not score_args.aggregate_query_gradients
            and min(d_in, d_out) > rank)


def lowrank_factors_full(
    gradient: torch.Tensor, rank: int, out_dtype
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact truncated SVD: (left = U_r S_r of shape (q, o, r), right = V_r^T
    of shape (q, r, i))."""
    u, s, vt = torch.linalg.svd(gradient, full_matrices=False)
    left = u[:, :, :rank] * s[:, None, :rank]
    right = vt[:, :rank, :]
    out = resolve_dtype(out_dtype)
    return left.to(out), right.to(out)


def sketch_width(gradient: torch.Tensor, rank: int, oversample: int = 8) -> int:
    """Columns of the Gaussian sketch: rank + oversample, at most min(o, i)."""
    return min(rank + oversample, min(gradient.shape[1:]))


def lowrank_factors_randomized(
    gradient: torch.Tensor,
    rank: int,
    out_dtype,
    generator: Optional[torch.Generator],
    n_iter: int = 2,
    oversample: int = 8,
    rows: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Randomized truncated SVD of a (q, o, i) batch (Halko et al. 2011): a
    Gaussian sketch of `rank + oversample` columns drawn from `generator` (on
    the gradient's device), `n_iter` rounds of QR power iterations, then the
    SVD of the small (k, i) projection. `rows = (start, total)` says the
    batch is rows `start:start + q` of a batch of `total` (a rank's slice on
    a data mesh): the sketch is drawn for all `total` rows and sliced, so the
    pairs are those of the whole batch."""
    q_count, _, i_dim = gradient.shape
    start, total = (0, q_count) if rows is None else rows
    omega = torch.randn(
        (total, i_dim, sketch_width(gradient, rank, oversample)),
        generator=generator, dtype=gradient.dtype, device=gradient.device,
    )[start:start + q_count]
    return _lowrank_factors_from_sketch(gradient, rank, out_dtype, omega, n_iter)


def _lowrank_factors_from_sketch(
    gradient: torch.Tensor, rank: int, out_dtype, omega: torch.Tensor, n_iter: int = 2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The randomized SVD's steps after the draw, on a given (q, i, k) sketch
    (the tests feed both packages one sketch)."""
    q_mat, _ = torch.linalg.qr(torch.matmul(gradient, omega))  # (q, o, k)
    for _ in range(n_iter):
        z, _ = torch.linalg.qr(torch.matmul(gradient.transpose(1, 2), q_mat))  # (q, i, k)
        q_mat, _ = torch.linalg.qr(torch.matmul(gradient, z))
    b = torch.matmul(q_mat.transpose(1, 2), gradient)  # (q, k, i)
    u_b, s, vt = torch.linalg.svd(b, full_matrices=False)
    left = torch.matmul(q_mat, u_b[:, :, :rank]) * s[:, None, :rank]
    right = vt[:, :rank, :]
    out = resolve_dtype(out_dtype)
    return left.to(out), right.to(out)
