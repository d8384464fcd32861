"""Batched symmetric eigensolver by blocked cyclic Jacobi.

Port of `kronfluence_tpu/ops/eigh.py` (the `eigendecomposition_solver=
"jacobi"` path): `eigh_batched`, `_padded_blocked_eigh`, `_small_eigh`,
`_blocked_jacobi_eigh` and the scalar-Jacobi helpers, with the same defaults,
chunk budget, padding and convergence rules.

  * Outer level: each n x n matrix is tiled into blocks of b rows; a sweep
    visits n/b - 1 rounds, and a round pairs the blocks round-robin, gathers
    the paired blocks next to each other, diagonalizes every 2b x 2b pivot
    block approximately, and applies the rotations to the whole matrix as
    batched (2b x 2b) @ (2b x n) products.
  * Inner level: every pivot solve is K2, `jacobi_pivot_rotations` (the JAX
    package's `use_pallas=True` route, `ops/eigh.py:208-214`). The JAX
    package's `_padded_blocked_eigh` drops that flag and runs its XLA scalar
    loop instead; the port takes the route the kernel was written for.
  * A coarse phase runs to a relative off-norm of 1e-3 within 3/4 of the
    sweep budget, a fine phase to max(tol, 8 eps sqrt(n)); then one
    Newton-Schulz step restores orthogonality and a Rayleigh quotient against
    the original matrix gives the eigenvalues, sorted ascending. Each phase
    tests convergence once per sweep on the host (one sync), against a
    Frobenius norm without the padded diagonal; the JAX package counts it,
    and its padded matrices stop early.
  * Every matrix product here runs in full fp32, whatever the caller's TF32
    setting (`full_fp32_matmul`).

Host-side index tables are built with numpy and moved to the device once per
call. `eigh_batched.chunks` records, for each chunk solved by the blocked
path, its padded size, matrix count, sweeps run and rounds per sweep: K2
launches once per round.

`eigh_jacobi_hostloop` is the JAX package's host-loop form of the same
solver (`_jacobi_one_sweep`, `_jacobi_polish`): each sweep a bounded call,
the convergence loop on the host, exact `torch.linalg.eigh` pivots by
default, split over CUDA streams on the card (K2's under `pivot="scalar"`).

`eigh_large` is the per-matrix protocol of the JAX package's `eigh_large`
for dimensions at or above `LARGE_EIGH_DIM` (Llama's MLP factors): each
matrix is built, solved alone and handed to a callback, so one matrix and
its solve are on the device at a time. The solve is `torch.linalg.eigh`
(cuSOLVER on the card, LAPACK on the CPU) under "auto", and the host loop at
block `LARGE_EIGH_BLOCK` under "jacobi" (the JAX package's default device
solve there). The JAX package's host-LAPACK retry after an out-of-memory
error and its `KF_LARGE_EIGH_*` switches are not ported: a failed solve
raises, and the per-matrix checkpoints the callback writes are what a rerun
resumes from.
"""

import concurrent.futures
import contextlib
import functools
import logging
import math
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from kronfluence_tpu_torch.ops.kernels.jacobi import MAX_M, jacobi_pivot_rotations
from kronfluence_tpu_torch.utils.logger import get_logger

_EPS = float(np.finfo(np.float32).eps)
_TINY = float(np.finfo(np.float32).tiny)
# Peak-memory bound of the batched solve: ~8 live (n, n) fp32 tensors per
# matrix, so a chunk holds at most this many elements of one of them
# (kronfluence_tpu/ops/eigh.py:860-863). Chunking decides which matrices share
# a convergence test, so the port keeps the JAX package's value.
CHUNK_BUDGET_ELEMS = 64_000_000
# At or above this dimension a factor group is solved one matrix at a time
# (`eigh_large`), never stacked.
LARGE_EIGH_DIM = 6144
# The host loop's block size at those dims (the JAX package's `eigh_large`
# default): 256 x 256 pivot blocks.
LARGE_EIGH_BLOCK = 128


@contextlib.contextmanager
def full_fp32_matmul():
    """fp32 matrix products without TF32 inside the block; the caller's
    setting is restored after it."""
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(previous)


def _round_robin_schedule(m: int) -> np.ndarray:
    """Tournament schedule: (m-1) rounds of m/2 disjoint index pairs."""
    assert m % 2 == 0
    players = list(range(m))
    rounds = []
    for _ in range(m - 1):
        pairs = []
        for k in range(m // 2):
            a, b = players[k], players[m - 1 - k]
            pairs.append((min(a, b), max(a, b)))
        rounds.append(sorted(pairs))
        players = [players[0], players[-1]] + players[1:-1]
    return np.asarray(rounds, np.int64)  # (m-1, m/2, 2)


@functools.lru_cache(maxsize=None)
def _scalar_schedule_tables(m: int):
    """Per-round (p, q, partner) index tables for scalar Jacobi on m x m."""
    sched = _round_robin_schedule(m)
    rounds = sched.shape[0]
    p_tab = sched[:, :, 0]
    q_tab = sched[:, :, 1]
    partner = np.zeros((rounds, m), np.int64)
    for r in range(rounds):
        partner[r, p_tab[r]] = q_tab[r]
        partner[r, q_tab[r]] = p_tab[r]
    return p_tab, q_tab, partner


def _scalar_jacobi_rotations(a_pp, a_qq, a_pq, eps: float):
    """Stable Jacobi rotation (c, s) zeroing a_pq (Rutishauser); a_pq ~ 0
    gives the identity rotation."""
    denom = 2.0 * a_pq
    tau = (a_qq - a_pp) / torch.where(denom == 0.0, torch.ones_like(denom), denom)
    sign_tau = torch.where(tau >= 0.0, 1.0, -1.0)
    t = sign_tau / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    scale = torch.sqrt((a_pp * a_qq).abs()) + a_pp.abs() + a_qq.abs()
    t = torch.where(a_pq.abs() > eps * scale, t, torch.zeros_like(t))
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c


def _scalar_jacobi(S: torch.Tensor, sweeps: int, eps: float) -> torch.Tensor:
    """Round-robin scalar cyclic Jacobi on a batch (Y, m, m); returns the
    rotations V (S = V S_final V^T). A loop over rounds on the whole batch."""
    y, m, _ = S.shape
    p_tab, q_tab, partner_tab = (
        torch.from_numpy(t).to(S.device) for t in _scalar_schedule_tables(m)
    )
    rounds = m - 1
    A = S
    V = torch.eye(m, dtype=S.dtype, device=S.device).expand(y, m, m)
    for step in range(sweeps * rounds):
        r = step % rounds
        p, q, partner = p_tab[r], q_tab[r], partner_tab[r]
        c, s = _scalar_jacobi_rotations(A[:, p, p], A[:, q, q], A[:, p, q], eps)
        alpha = torch.ones((y, m), dtype=A.dtype, device=A.device)
        beta = torch.zeros((y, m), dtype=A.dtype, device=A.device)
        alpha[:, p] = c
        alpha[:, q] = c
        beta[:, p] = -s
        beta[:, q] = s
        # Rows: R^T A; columns: (.) R; V: V R.
        A = alpha[:, :, None] * A + beta[:, :, None] * A.index_select(1, partner)
        A = alpha[:, None, :] * A + beta[:, None, :] * A.index_select(2, partner)
        V = alpha[:, None, :] * V + beta[:, None, :] * V.index_select(2, partner)
    return V


@functools.lru_cache(maxsize=None)
def _block_index_tables(n: int, two_b: int):
    """Per-round row permutations that put paired blocks side by side.

    `delta[r]` maps round r-1's layout straight to round r's (delta[0] takes
    the canonical layout), and `restore` maps the last round's layout back to
    canonical, so a sweep starts and ends in canonical layout.
    """
    b = two_b // 2
    sched = _round_robin_schedule(n // b)
    rounds = sched.shape[0]
    perm = np.zeros((rounds, n), np.int64)
    inv = np.zeros((rounds, n), np.int64)
    for r in range(rounds):
        order = []
        for p, q in sched[r]:
            order.extend(range(p * b, (p + 1) * b))
            order.extend(range(q * b, (q + 1) * b))
        perm[r] = order
        inv[r, perm[r]] = np.arange(n)
    delta = np.zeros_like(perm)
    delta[0] = perm[0]
    for r in range(1, rounds):
        delta[r] = inv[r - 1][perm[r]]
    return delta, inv[rounds - 1]


def _sweep(A, W, delta, restore, two_b: int, solve_pivots):
    """One blocked-Jacobi sweep: `solve_pivots` maps a round's (Y, 2b, 2b)
    pivot blocks to their rotations. Enters and leaves canonical layout, and
    re-symmetrizes A at the end. Each round drops its inputs as its outputs
    are formed, so a sweep holds about four (n, n) tensors a matrix beside
    what the caller keeps."""
    x, n, _ = A.shape
    np_pairs = n // two_b
    for r in range(delta.shape[0]):
        d = delta[r]
        Ap = A.index_select(1, d).index_select(2, d)
        Wp = W.index_select(2, d)
        del A, W
        # The np_pairs diagonal 2b x 2b pivot blocks of each matrix.
        S = Ap.view(x, np_pairs, two_b, np_pairs, two_b).diagonal(dim1=1, dim2=3)
        S = S.permute(0, 3, 1, 2).contiguous().view(x * np_pairs, two_b, two_b)
        V = solve_pivots(S).view(x, np_pairs, two_b, two_b)
        del S
        # Rows: V^T @ (paired rows); columns: (.) @ V; accumulate W @ V.
        rows = torch.matmul(V.transpose(-1, -2), Ap.view(x, np_pairs, two_b, n))
        del Ap
        cols = torch.matmul(rows.view(x, n, np_pairs, two_b).transpose(1, 2), V)
        del rows
        A = cols.transpose(1, 2).reshape(x, n, n)
        del cols
        W = torch.matmul(Wp.view(x, n, np_pairs, two_b).transpose(1, 2), V)
        del Wp
        W = W.transpose(1, 2).reshape(x, n, n)
    A = A.index_select(1, restore).index_select(2, restore)
    W = W.index_select(2, restore)
    return 0.5 * (A + A.transpose(1, 2)), W


def _reference_sq(A: torch.Tensor, off_mask: torch.Tensor) -> torch.Tensor:
    """Per matrix, the squared Frobenius norm the convergence tests measure
    the off-norm against. It leaves out diagonal entries whose row is zero
    off the diagonal: the Gershgorin padding (4 * bound + 1 each) is
    decoupled, and counted in, it loosens the test for the true block (the
    JAX package counts it: its padded matrices stop early)."""
    off = A * off_mask
    decoupled = off.abs().sum(dim=2) == 0
    diag_sq = torch.where(decoupled, 0.0, A.diagonal(dim1=1, dim2=2).square())
    return torch.sum(off.square(), dim=(1, 2)) + diag_sq.sum(dim=1)


def _blocked_jacobi_eigh(
    A: torch.Tensor,
    block_size: int,
    inner_sweeps: int,
    max_sweeps: int,
    tol: float,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Core solver: A (X, n, n) fp32 symmetric, n a multiple of 2 * block_size.
    Returns ascending eigenvalues, eigenvectors and the sweeps run."""
    x, n, _ = A.shape
    two_b = 2 * block_size
    delta, restore = (torch.from_numpy(t).to(A.device) for t in _block_index_tables(n, two_b))
    eps = _EPS
    off_mask = 1.0 - torch.eye(n, dtype=A.dtype, device=A.device)

    def not_done(A, loop_tol):
        # Strictly off-diagonal sum: no cancellation, so the test can stop early.
        off_sq = torch.sum(torch.square(A * off_mask), dim=(1, 2))
        return bool(torch.any(off_sq > (loop_tol * loop_tol) * total_sq))

    def solve_pivots(S):
        return jacobi_pivot_rotations(S, inner_sweeps, eps)

    total_sq = _reference_sq(A, off_mask)
    # fp32 rotations floor the off-norm at ~eps sqrt(n) relative.
    f32 = dict(dtype=torch.float32, device=A.device)
    tol = torch.maximum(torch.tensor(tol, **f32), torch.tensor(8.0 * eps * math.sqrt(n), **f32))
    coarse_tol = torch.maximum(torch.tensor(1e-3, **f32), tol)
    A0 = A
    W = torch.eye(n, dtype=A.dtype, device=A.device).expand(x, n, n)
    sweeps = 0
    with full_fp32_matmul():
        for loop_tol, budget in ((coarse_tol, max(1, (3 * max_sweeps) // 4)), (tol, max_sweeps)):
            while sweeps < budget and not_done(A, loop_tol):
                A, W = _sweep(A, W, delta, restore, two_b, solve_pivots)
                sweeps += 1
        evals, W = _polish(A0, W)
    return evals, W, sweeps


def _polish(A0: torch.Tensor, W: torch.Tensor, ns_steps: int = 1):
    """`ns_steps` Newton-Schulz steps restore W's orthogonality; Rayleigh
    quotients against the original matrix give the eigenvalues; ascending
    sort."""
    for _ in range(ns_steps):
        wtw = torch.matmul(W.transpose(1, 2), W)
        W = 0.5 * (3.0 * W - torch.matmul(W, wtw))
        del wtw
    evals = torch.sum(W * torch.matmul(A0, W), dim=1)
    order = torch.argsort(evals, dim=1, stable=True)
    return torch.gather(evals, 1, order), torch.gather(W, 2, order[:, None, :].expand(W.shape))


def gershgorin_pad(A: torch.Tensor, m: int) -> torch.Tensor:
    """Embeds (x, n, n) in (x, m, m), the padded diagonal at 4 * (Gershgorin
    bound) + 1, so the padded eigenpairs sort above the true spectrum."""
    x, n, _ = A.shape
    if m == n:
        return A
    bound = A.abs().sum(dim=2).amax(dim=1)
    big = A.new_zeros((x, m, m))
    big[:, :n, :n] = A
    idx = torch.arange(n, m, device=A.device)
    big[:, idx, idx] = (4.0 * bound + 1.0)[:, None]
    return big


def _padded_blocked_eigh(A, n, block_size, inner_sweeps, max_sweeps, tol):
    two_b = 2 * block_size
    n_pad = int(math.ceil(n / two_b) * two_b)
    evals, vecs, sweeps = _blocked_jacobi_eigh(
        gershgorin_pad(A, n_pad), block_size, inner_sweeps, max_sweeps, tol
    )
    eigh_batched.chunks.append(
        {"n": n_pad, "matrices": A.shape[0], "sweeps": sweeps, "rounds_per_sweep": n_pad // block_size - 1}
    )
    return evals[:, :n], vecs[:, :n, :n]


def _small_eigh(A, m, n, inner_sweeps, max_sweeps):
    """n <= 2 * block_size: scalar Jacobi on the whole (even-padded) matrix."""
    A = gershgorin_pad(A, m)
    V = _scalar_jacobi(A, inner_sweeps * max_sweeps, _EPS)
    with full_fp32_matmul():
        D = torch.matmul(torch.matmul(V.transpose(1, 2), A), V)
    evals = D.diagonal(dim1=1, dim2=2)
    order = torch.argsort(evals, dim=1, stable=True)
    evals = torch.gather(evals, 1, order)
    V = torch.gather(V, 2, order[:, None, :].expand(V.shape))
    return evals[:, :n], V[:, :n, :n]


def eigh_batched(
    matrices: torch.Tensor,
    block_size: int = 32,
    inner_sweeps: int = 2,
    max_sweeps: int = 16,
    tol: float = 1e-6,
    budget_elems: int = CHUNK_BUDGET_ELEMS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched symmetric eigendecomposition, ascending eigenvalues.

    Args:
        matrices: (..., n, n) symmetric; solved in fp32.
        block_size: outer Jacobi block size b; pivot blocks are 2b x 2b.
        inner_sweeps: K2 sweeps per pivot solve (approximate solves suffice;
            the outer iteration absorbs the residual).
        max_sweeps: outer sweep cap.
        tol: relative off-diagonal Frobenius tolerance for early exit.
        budget_elems: elements of one (n, n) tensor over a chunk of matrices.

    Returns:
        (eigenvalues (..., n), eigenvectors (..., n, n)) with
        A ~= V @ diag(w) @ V^T, the columns of V the eigenvectors.
    """
    batch_shape = matrices.shape[:-2]
    n = matrices.shape[-1]
    A = matrices.reshape((-1, n, n)).to(torch.float32)
    if n <= 2 * block_size:
        evals, vecs = _small_eigh(A, n + (n % 2), n, inner_sweeps, max_sweeps)
    else:
        chunk = max(1, min(A.shape[0], budget_elems // (n * n)))
        parts = [
            _padded_blocked_eigh(A[start : start + chunk], n, block_size, inner_sweeps, max_sweeps, tol)
            for start in range(0, A.shape[0], chunk)
        ]
        evals = torch.cat([p[0] for p in parts])
        vecs = torch.cat([p[1] for p in parts])
    return evals.reshape(batch_shape + (n,)), vecs.reshape(batch_shape + (n, n))


eigh_batched.chunks = []


# Host threads, each with a CUDA stream of its own, over which a round's exact
# pivot solves are split on the card.
PIVOT_STREAMS = 8


@functools.lru_cache(maxsize=None)
def _pivot_workers(device_index: int):
    streams = tuple(torch.cuda.Stream(device_index) for _ in range(PIVOT_STREAMS))
    return streams, concurrent.futures.ThreadPoolExecutor(PIVOT_STREAMS)


def exact_pivot_rotations(S: torch.Tensor) -> torch.Tensor:
    """The eigenvectors of each (2b, 2b) pivot block, `torch.linalg.eigh`,
    each made orthogonal to fp32 rounding by one Newton-Schulz step.

    The step is the port's own: fp32 eigenvectors are orthogonal only to
    about 1e-6 at 2b = 256, and at n 14336 a solve applies some 1,400 such
    rotations to W, whose drift the final polish turns into eigenvector
    error (a reconstruction residual of 8.6e-4 against n u = 8.5e-4 on an
    H100 without the step).

    On the card cuSOLVER solves one block at a time at these sizes, with host
    synchronizations inside each solve that leave the card idle; so the
    blocks are split over PIVOT_STREAMS host threads, each on its own stream,
    and their solves overlap. Each block's eigenvectors are the ones a lone
    call gives."""
    V = _pivot_eigenvectors(S)
    return 1.5 * V - 0.5 * (V @ (V.transpose(1, 2) @ V))


def _pivot_eigenvectors(S: torch.Tensor) -> torch.Tensor:
    if S.device.type != "cuda" or S.shape[0] < 2:
        return torch.linalg.eigh(S)[1]
    streams, pool = _pivot_workers(S.device.index)
    parts = S.tensor_split(min(len(streams), S.shape[0]))
    main = torch.cuda.current_stream(S.device)

    def solve(i):
        with torch.cuda.stream(streams[i]):
            streams[i].wait_stream(main)
            vecs = torch.linalg.eigh(parts[i])[1]
            vecs.record_stream(main)
            return vecs

    out = list(pool.map(solve, range(len(parts))))
    for stream, part in zip(streams, parts):
        main.wait_stream(stream)
        part.record_stream(stream)
    return torch.cat(out)


def _hostloop_sweep(A, W, delta, restore, two_b, off_mask, pivot, inner_sweeps):
    """The JAX package's `_jacobi_one_sweep`: one sweep of n/b - 1 rounds,
    returning (A, W, off) with off each matrix's squared off-diagonal norm.
    `pivot="eigh"` diagonalizes every pivot block exactly with
    `torch.linalg.eigh` (`exact_pivot_rotations`; XLA's batched eigh in the
    JAX package); "scalar" takes K2's approximate rotations, as every
    approximate pivot solve of the port does."""
    if pivot == "eigh":
        solve_pivots = exact_pivot_rotations
    else:
        def solve_pivots(S):
            return jacobi_pivot_rotations(S, inner_sweeps, _EPS)
    A, W = _sweep(A, W, delta, restore, two_b, solve_pivots)
    return A, W, torch.sum(torch.square(A * off_mask), dim=(1, 2))


def eigh_jacobi_hostloop(
    matrices: torch.Tensor,
    block_size: int = 32,
    inner_sweeps: int = 2,
    max_sweeps: int = 24,
    tol: float = 1e-6,
    pivot: str = "eigh",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked-Jacobi eigendecomposition with the convergence loop on the
    host, ascending eigenvalues. Port of the JAX package's
    `eigh_jacobi_hostloop`, the solve of its `eigh_large` at Llama dims.

    Each sweep is its own call (`_hostloop_sweep`), and one host read of the
    per-matrix off-norm after it decides the next: a coarse phase to 1e-3
    relative off-norm within half of `max_sweeps`, then a fine phase to
    max(tol, 8 eps sqrt(n_pad)) that also stops when a sweep leaves the
    off-norm at 0.9 of the previous one or more (the fp32 rotation floor).
    Then Newton-Schulz steps (3 at n_pad >= 4096, 1 below) and the Rayleigh
    quotient against the original matrix, the ascending sort and the slice
    to n. The matrix is padded to a multiple of 2b as `eigh_batched` pads
    it, and the convergence tests use `eigh_batched`'s reference norm.

    The JAX package runs its coarse phase at Precision.HIGH (bf16_3x); here
    every product runs in full fp32 (`full_fp32_matmul`), as in
    `eigh_batched`. `pivot="scalar"` on a CUDA tensor takes K2, which holds
    pivot blocks of 2b <= MAX_M; a larger 2b raises ValueError.

    `eigh_jacobi_hostloop.solves` records each call's padded size, matrix
    count, pivot form, rounds per sweep, sweeps and each sweep's relative
    off-norm.
    """
    if pivot not in ("eigh", "scalar"):
        raise ValueError(f"pivot must be 'eigh' or 'scalar'; got {pivot!r}.")
    two_b = 2 * block_size
    if pivot == "scalar" and matrices.device.type == "cuda" and two_b > MAX_M:
        raise ValueError(
            f"pivot='scalar' solves 2b x 2b pivot blocks with K2, which holds m <= {MAX_M} on "
            f"the card; block_size {block_size} gives {two_b}."
        )
    batch_shape = matrices.shape[:-2]
    n = matrices.shape[-1]
    n_pad = int(math.ceil(n / two_b) * two_b)
    A0 = gershgorin_pad(matrices.reshape((-1, n, n)).to(torch.float32), n_pad)
    x = A0.shape[0]
    delta, restore = (
        torch.from_numpy(t).to(A0.device) for t in _block_index_tables(n_pad, two_b)
    )
    off_mask = 1.0 - torch.eye(n_pad, dtype=A0.dtype, device=A0.device)
    total_sq = _reference_sq(A0, off_mask).cpu().numpy()
    floor = max(tol, 8.0 * _EPS * math.sqrt(n_pad))
    record = {"n": n_pad, "matrices": x, "pivot": pivot, "rounds_per_sweep": n_pad // block_size - 1,
              "sweeps": 0, "off": []}
    eigh_jacobi_hostloop.solves.append(record)
    A, W = A0, torch.eye(n_pad, dtype=A0.dtype, device=A0.device).expand(x, n_pad, n_pad)
    prev_off = None
    with full_fp32_matmul():
        for fine in (False, True):
            loop_tol = floor if fine else max(1e-3, floor)
            budget = max_sweeps if fine else max(1, max_sweeps // 2)
            while record["sweeps"] < budget:
                A, W, off_t = _hostloop_sweep(
                    A, W, delta, restore, two_b, off_mask, pivot, inner_sweeps
                )
                off = off_t.cpu().numpy()
                record["sweeps"] += 1
                record["off"].append(float(np.max(np.sqrt(off / np.maximum(total_sq, _TINY)))))
                if bool(np.all(off <= (loop_tol * loop_tol) * total_sq)):
                    break
                if fine and prev_off is not None and bool(np.all(off >= 0.9 * prev_off)):
                    break
                prev_off = off if fine else None
        del A, off_mask
        evals, vecs = _polish(A0, W, 3 if n_pad >= 4096 else 1)
    return (
        evals[:, :n].reshape(batch_shape + (n,)),
        vecs[:, :n, :n].reshape(batch_shape + (n, n)),
    )


eigh_jacobi_hostloop.solves = []


def jacobi_hostloop_solve(matrix: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`eigh_large`'s solve under `eigendecomposition_solver="jacobi"`: one
    (n, n) matrix through the host loop at the JAX package's block size for
    Llama dims (`LARGE_EIGH_BLOCK`), exact pivots."""
    evals, vecs = eigh_jacobi_hostloop(matrix[None], block_size=LARGE_EIGH_BLOCK)
    return evals[0], vecs[0]


def eigh_large(
    matrices: Sequence[Callable[[], torch.Tensor]],
    on_result: Callable[[int, torch.Tensor, torch.Tensor], None],
    solve: Optional[Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]] = None,
) -> None:
    """Solves large symmetric matrices one at a time, ascending eigenvalues.

    `matrices[i]()` builds the i-th (n, n) matrix when its solve starts;
    `solve` (default `torch.linalg.eigh`: cuSOLVER on the card, LAPACK on
    the CPU; `jacobi_hostloop_solve` under "jacobi") solves it on the
    matrix's device; `on_result(i, evals, evecs)` takes the result as it
    lands. Every reference to the matrix and its result is dropped before
    the next matrix is built, so the device holds what was resident, what
    the callback keeps, and one matrix with its solve. A failed solve raises
    (no host retry).
    """
    solve = torch.linalg.eigh if solve is None else solve
    log = get_logger("kronfluence_tpu_torch.ops.eigh", level=logging.INFO)
    for i, build in enumerate(matrices):
        start = time.perf_counter()
        matrix = build()
        n, device = matrix.shape[-1], matrix.device
        evals, evecs = solve(matrix)
        del matrix
        on_result(i, evals, evecs)
        del evals, evecs
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        log.info(
            "eigh_large: matrix %d/%d (dim %d) solved in %.1f s",
            i + 1, len(matrices), n, time.perf_counter() - start,
        )
