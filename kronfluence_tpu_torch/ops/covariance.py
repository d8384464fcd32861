"""Covariance accumulation math: grams and per-sample gradients.

Port of `kronfluence_tpu/ops/covariance.py` (not its patch-free conv gram,
nor the experimental, never dispatched `conv_per_sample_gradient`). Each
batch contributes one `A^T A` (and one `G^T G`) accumulated in the
accumulation dtype, so bf16 operands accumulate in fp32. A conv layer's
activation gram is the gram of its im2col patches, which K1 takes where it
is wide: on an H100 that was 3-7x faster than the JAX package's
symmetric-block form at ResNet-9's 512-channel convs. The meshed syrk route
needs no code of its own: on a data mesh each rank's `gram` takes its own
rows (K1 per rank) with no collective per gram, and the stage driver
(`factor/covariance.py`) all-reduces the sums once a stage.
"""

import torch

from kronfluence_tpu_torch.ops.kernels.syrk import syrk, syrk_reference, syrk_supported
from kronfluence_tpu_torch.utils.dtypes import resolve_dtype


def gram(flat: torch.Tensor, accum_dtype) -> torch.Tensor:
    """Returns `flat^T @ flat` in the accumulation dtype.

    Widths that pass the JAX package's shape rule (`syrk_supported`: fp32
    accumulation, at least 4 column tiles of 512) go to the K1 triangle
    kernel, which on a CPU tensor is its plain version. Narrower widths (768,
    769 on GPT-2) take the plain product, as the JAX package left them to XLA.
    """
    accum = resolve_dtype(accum_dtype)
    if syrk_supported(flat.shape[-1], accum):
        return syrk(flat, accum)
    return syrk_reference(flat, accum)


def bordered_gram(
    a2: torch.Tensor, count: torch.Tensor, has_bias: bool, accum_dtype
) -> torch.Tensor:
    """Gram of a masked activation with the bias ones-column added as an
    analytic border: `[[A^T A, A^T 1], [1^T A, count]]` equals
    `gram([A | mask])` for a 0/1 row mask already applied to A."""
    accum = resolve_dtype(accum_dtype)
    g = gram(a2, accum)
    if not has_bias:
        return g
    col = a2.sum(dim=0, dtype=accum)[:, None]
    corner = count.to(accum).reshape(1, 1)
    return torch.cat([torch.cat([g, col], dim=1), torch.cat([col.T, corner], dim=1)], dim=0)


def per_sample_gradient(
    activation_tokens: torch.Tensor,  # (batch, tokens, in_dim[+1])
    gradient_tokens: torch.Tensor,  # (batch, tokens, out_dim)
    accum_dtype,
) -> torch.Tensor:
    """Per-sample weight gradients, shape (batch, out_dim, in_dim[+1]), with
    the token contraction in the accumulation dtype."""
    accum = resolve_dtype(accum_dtype)
    return torch.einsum(
        "bto,bti->boi", gradient_tokens.to(accum), activation_tokens.to(accum)
    )


def summed_gradient(
    activation_tokens: torch.Tensor,
    gradient_tokens: torch.Tensor,
    accum_dtype,
) -> torch.Tensor:
    """Batch-summed weight gradient, shape (out_dim, in_dim[+1])."""
    accum = resolve_dtype(accum_dtype)
    return torch.einsum(
        "bto,bti->oi", gradient_tokens.to(accum), activation_tokens.to(accum)
    )
