"""Score contractions for dense and low-rank preconditioned query gradients.

Port of `kronfluence_tpu/ops/scores.py:pairwise_score`. Notation: q=query,
b=train-batch, t=token, o=out_dim, i=in_dim(+1), r=rank. The JAX package lets
opt_einsum plan the multi-operand forms; torch.einsum contracts left to right
unless opt_einsum is installed, so every order here is written out, chosen by
multiply-adds at the call's shapes.
"""

from typing import Tuple, Union

import torch

from kronfluence_tpu_torch.utils.dtypes import resolve_dtype

PreconditionedGradient = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def lowrank_route(q: int, o: int, i: int, r: int, b: int, t: int) -> str:
    """How `pairwise_score` contracts a low-rank block per sequence: "tokens"
    projects the train tokens onto each query's factors (q*b*t*r*(o+i)
    multiply-adds); "rebuild" forms the dense (q, o, i) block and takes the
    dense form (q*o*i*r + b*t*o*i + q*b*o*i). At GPT-2's c_fc (o 3072, i 769,
    r 32, b 16, t 512) the tokens win at q 16 and the rebuild at q 481."""
    tokens = q * b * t * r * (o + i)
    rebuild = q * o * i * r + b * t * o * i + q * b * o * i
    return "tokens" if tokens <= rebuild else "rebuild"


def lowrank_transient_elements(q: int, o: int, i: int, r: int, b: int, t: int) -> int:
    """Elements of the temporaries the low-rank route holds beyond its inputs
    and its result: the two (b, t, q, r) token projections, or the rebuilt
    (q, o, i) block (the dense form's (b, o, i) per-sample gradients are the
    memory model's own per-example term)."""
    if lowrank_route(q, o, i, r, b, t) == "tokens":
        return 2 * q * b * t * r
    return q * o * i


def rebuild(left: torch.Tensor, right: torch.Tensor, dtype=None) -> torch.Tensor:
    """The dense (q, o, i) block `left @ right` of a low-rank pair."""
    if dtype is not None:
        left, right = left.to(dtype), right.to(dtype)
    return torch.matmul(left, right)


def pairwise_score(
    preconditioned: PreconditionedGradient,  # (q, o, i) or ((q, o, r), (q, r, i))
    a_tok: torch.Tensor,  # (b, t, i)
    g_tok: torch.Tensor,  # (b, t, o)
    per_token: bool,
    out_dtype,
) -> torch.Tensor:
    """score[q, b(, t)] = <P(q), g_b(,t)>.

    The dense form contracts the train tokens into per-sample gradients
    first: b*t*o*i + q*b*o*i multiply-adds, against q*b*t*o*i for contracting
    the query block with the tokens. A low-rank pair takes `lowrank_route`
    per sequence, and the token projections per token.
    """
    out = resolve_dtype(out_dtype)
    if isinstance(preconditioned, tuple):
        left, right = preconditioned
        dtype = torch.promote_types(
            torch.promote_types(left.dtype, right.dtype),
            torch.promote_types(a_tok.dtype, g_tok.dtype),
        )
        (q, o, r), (b, t, i) = left.shape, a_tok.shape
        if not per_token and lowrank_route(q, o, i, r, b, t) == "rebuild":
            return pairwise_score(rebuild(left, right, dtype), a_tok, g_tok, False, out)
        # Both projections as one GEMM each, (b t, o) @ (o, q r) and
        # (b t, i) @ (i, q r), multiplied in place: two (b, t, q, r)
        # temporaries.
        u = torch.matmul(
            g_tok.to(dtype).reshape(b * t, o), left.to(dtype).permute(1, 0, 2).reshape(o, q * r)
        ).view(b, t, q, r)
        v = torch.matmul(
            a_tok.to(dtype).reshape(b * t, i), right.to(dtype).permute(2, 0, 1).reshape(i, q * r)
        ).view(b, t, q, r)
        u.mul_(v)
        del v
        if per_token:
            return u.sum(dim=-1).permute(2, 0, 1).to(out)
        return u.sum(dim=(1, 3)).T.to(out)
    dtype = torch.promote_types(preconditioned.dtype, torch.promote_types(a_tok.dtype, g_tok.dtype))
    p, a, g = preconditioned.to(dtype), a_tok.to(dtype), g_tok.to(dtype)
    if per_token:
        rotated = torch.einsum("qoi,bti->qbto", p, a)
        score = (rotated * g[None]).sum(dim=-1)
    else:
        psg = torch.einsum("bto,bti->boi", g, a)
        score = torch.einsum("qoi,boi->qb", p, psg)
    return score.to(out)
