"""Score contractions for dense preconditioned query gradients.

Port of the dense forms of `kronfluence_tpu/ops/scores.py:pairwise_score`.
Notation: q=query, b=train-batch, t=token, o=out_dim, i=in_dim(+1).
"""

import torch

from kronfluence_tpu_torch.utils.dtypes import resolve_dtype


def pairwise_score(
    preconditioned: torch.Tensor,  # (q, o, i)
    a_tok: torch.Tensor,  # (b, t, i)
    g_tok: torch.Tensor,  # (b, t, o)
    per_token: bool,
    out_dtype,
) -> torch.Tensor:
    """score[q, b(, t)] = <P(q), g_b(,t)>.

    The dense form contracts the train tokens into per-sample gradients
    first: b*t*o*i + q*b*o*i multiply-adds, against q*b*t*o*i for contracting
    the query block with the tokens.
    """
    if isinstance(preconditioned, tuple):
        raise NotImplementedError(
            "Low-rank query gradients are not ported yet "
            "(ROADMAP Queue 1, remaining score features)."
        )
    dtype = torch.promote_types(preconditioned.dtype, torch.promote_types(a_tok.dtype, g_tok.dtype))
    p, a, g = preconditioned.to(dtype), a_tok.to(dtype), g_tok.to(dtype)
    if per_token:
        rotated = torch.einsum("qoi,bti->qbto", p, a)
        score = (rotated * g[None]).sum(dim=-1)
    else:
        psg = torch.einsum("bto,bti->boi", g, a)
        score = torch.einsum("qoi,boi->qb", p, psg)
    return score.to(resolve_dtype(out_dtype))
