"""Eigendecomposition and Lambda (EK-FAC eigenvalue correction) stage drivers.

Port of `kronfluence_tpu/factor/eigen.py`:

  * `perform_eigendecomposition` eigendecomposes each normalized, symmetrized
    covariance factor. float32 on a CUDA device runs on the device with the
    solver `factor_args.eigendecomposition_solver` names: "auto" and "qdwh"
    run `torch.linalg.eigh` (cuSOLVER, the card's counterpart of XLA's eigh),
    batched over same-dimension matrices of both factor families; "jacobi"
    runs the blocked-Jacobi solver (`ops/eigh.py`, pivot solves in K2) on the
    JAX package's merged dimension groups, and its host-loop form one matrix
    at a time at dimensions >= LARGE_EIGH_DIM; "dc" is TPU-only and raises.
    Every other case runs the host fp64 (LAPACK) path that keeps the reference's
    numerics for parity tests.
  * `fit_lambda_matrices_with_loader` accumulates `Λ += Σ_b (Q_g^T g_b Q_a)^2`,
    by default rotating the activation / gradient token streams into the
    eigenbases before forming per-sample gradients (same result by
    associativity, fewer FLOPs when tokens per sample < activation dim).

On a data mesh (`parallel/mesh.py`) every rank eigendecomposes the same
all-reduced covariance factors, so the eigenpairs are replicated, as the
JAX package's global arrays are; the lambda stage sums each rank's rows and
all-reduces its matrices and counts once, at the end.
"""

import functools
import logging
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from kronfluence_tpu_torch.arguments import FactorArguments
from kronfluence_tpu_torch.capture.engine import capture
from kronfluence_tpu_torch.factor.config import get_factor_config
from kronfluence_tpu_torch.factor.covariance import (
    cast_params,
    discover_stage_specs,
    loss_scale_for,
    train_loss_forward,
    with_tracked,
)
from kronfluence_tpu_torch.ops.covariance import per_sample_gradient as psg_op
from kronfluence_tpu_torch.ops.eigh import (
    LARGE_EIGH_DIM,
    eigh_batched,
    eigh_large,
    gershgorin_pad,
    jacobi_hostloop_solve,
)
from kronfluence_tpu_torch.ops.flatten import activation_tokens_with_bias, gradient_tokens
from kronfluence_tpu_torch.parallel.mesh import all_reduce_tree, check_loader
from kronfluence_tpu_torch.prepare import PreparedModel
from kronfluence_tpu_torch.task import Task
from kronfluence_tpu_torch.utils.constants import (
    ACTIVATION_COVARIANCE_MATRIX_NAME,
    ACTIVATION_EIGENVALUES_NAME,
    ACTIVATION_EIGENVECTORS_NAME,
    GRADIENT_COVARIANCE_MATRIX_NAME,
    GRADIENT_EIGENVALUES_NAME,
    GRADIENT_EIGENVECTORS_NAME,
    LAMBDA_MATRIX_NAME,
    NUM_ACTIVATION_COVARIANCE_PROCESSED,
    NUM_GRADIENT_COVARIANCE_PROCESSED,
    NUM_LAMBDA_PROCESSED,
)
from kronfluence_tpu_torch.utils.dataset import probe_first
from kronfluence_tpu_torch.utils.dtypes import (
    accumulation_dtype,
    canonical_dtype_name,
    resolve_dtype,
)
from kronfluence_tpu_torch.utils.exceptions import FactorsNotFoundError
from kronfluence_tpu_torch.utils.logger import get_logger
from kronfluence_tpu_torch.utils.save import load_file, save_file

_FACTOR_PAIRS = (
    (
        ACTIVATION_COVARIANCE_MATRIX_NAME,
        NUM_ACTIVATION_COVARIANCE_PROCESSED,
        ACTIVATION_EIGENVECTORS_NAME,
        ACTIVATION_EIGENVALUES_NAME,
    ),
    (
        GRADIENT_COVARIANCE_MATRIX_NAME,
        NUM_GRADIENT_COVARIANCE_PROCESSED,
        GRADIENT_EIGENVECTORS_NAME,
        GRADIENT_EIGENVALUES_NAME,
    ),
)


def _normalize_stacked(stacked: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    mats = stacked.to(torch.float32) / counts[:, None, None].to(torch.float32)
    return 0.5 * (mats + mats.transpose(1, 2))


def _merge_dim_groups(groups: Dict[int, list]) -> Dict[int, list]:
    """Clusters factor groups whose dims differ by a small pad.

    Returns {target_dim: [(key, orig_dim), ...]}. A dim within
    max(8, dim // 256) below an already-placed larger dim is padded up to it;
    distant dims stay apart.
    """
    merged: Dict[int, list] = {}
    for dim in sorted(groups, reverse=True):
        target = dim
        for t in merged:
            if t >= dim and (t - dim) <= max(8, dim // 256):
                target = t
                break
        merged.setdefault(target, []).extend((key, dim) for key in groups[dim])
    return merged


def _dim_groups(covariance_factors) -> Dict[int, list]:
    """{dim: [(pair_idx, module_name), ...]} across both factor families."""
    groups: Dict[int, list] = {}
    for pair_idx, (cov_name, _count, _evec, _eval) in enumerate(_FACTOR_PAIRS):
        for module_name, mat in covariance_factors[cov_name].items():
            groups.setdefault(mat.shape[0], []).append((pair_idx, module_name))
    return groups


def _assemble_group(covariance_factors, entries, target: int):
    """Stacks, normalizes, symmetrizes and pads one merged group: each (n, n)
    matrix goes into a (target, target) one whose padded diagonal sorts above
    the true spectrum, so the appended eigenpairs land last and are sliced
    off (768 and 769, the bias column, share one solve). Sub-stacks run by
    (original dim descending, family), as in the JAX package, since the
    order decides which matrices share a chunk. Returns the batch and the
    [(pair_idx, module_name, dim), ...] order of its matrices."""
    by_key: Dict[tuple, list] = {}
    for (pair_idx, module_name), dim in entries:
        by_key.setdefault((dim, pair_idx), []).append(module_name)
    keys = sorted(by_key, key=lambda k: (-k[0], k[1]))
    order, parts = [], []
    for dim, pair_idx in keys:
        cov_name, count_name = _FACTOR_PAIRS[pair_idx][:2]
        names = by_key[(dim, pair_idx)]
        stacked = torch.stack([covariance_factors[cov_name][n] for n in names])
        counts = torch.stack([covariance_factors[count_name][n].reshape(()) for n in names])
        parts.append(gershgorin_pad(_normalize_stacked(stacked, counts), target))
        order.extend((pair_idx, n, dim) for n in names)
    return torch.cat(parts), order


def _split_group_result(ev, vec, dim: int):
    """One padded eigenpair set -> the true one: the true eigenpairs sort
    first, their vectors' padded-row components are ~eps; slice, renormalize."""
    if dim == ev.shape[0]:
        return ev, vec
    vec = vec[:dim, :dim]
    return ev[:dim], vec / torch.linalg.norm(vec, dim=0, keepdim=True)


def _checkpoint_path(scratch_dir, eval_name: str, module_name: str) -> Path:
    """One solved matrix's checkpoint, in the JAX package's names."""
    return Path(scratch_dir) / f"{eval_name}.{module_name.replace('/', '__')}.safetensors"


def _normalized(covariance_factors, pair_idx: int, module_name: str) -> torch.Tensor:
    """One factor in fp32, divided by its count and symmetrized, built
    without a stack (the values `_normalize_stacked` gives that matrix)."""
    cov_name, count_name = _FACTOR_PAIRS[pair_idx][:2]
    count = covariance_factors[count_name][module_name].reshape(()).to(torch.float32)
    matrix = covariance_factors[cov_name][module_name].to(torch.float32) / count
    return (matrix + matrix.T).mul_(0.5)


def _large_group_eigendecomposition(
    covariance_factors, eigen_factors, entries, scratch_dir=None, solve=None
) -> None:
    """Per-matrix path for dims >= LARGE_EIGH_DIM (Llama's MLP factors), after
    the JAX package's. Each matrix is normalized and symmetrized alone and
    solved by `eigh_large` with `solve` (cuSOLVER when None, the host-loop
    Jacobi under "jacobi"); the group is never stacked, so the device holds
    one matrix and its solve beside the results (six 14336-dim factors
    stacked are 4.9 GB in fp32 before the solver's copies). Each result goes
    to its covariance's dtype and device.

    `scratch_dir`: each solved matrix's eigenpairs are written there as it
    lands (through a temporary file and a rename) and reloaded on a rerun
    instead of being solved again; the FactorComputer deletes the directory
    once the eigendecomposition artifact is saved."""
    pending = []
    for (pair_idx, module_name), _dim in entries:
        cov_name, _count, evec_name, eval_name = _FACTOR_PAIRS[pair_idx]
        original = covariance_factors[cov_name][module_name]
        ckpt = None if scratch_dir is None else _checkpoint_path(scratch_dir, eval_name, module_name)
        if ckpt is not None and ckpt.exists():
            saved = load_file(ckpt, device=original.device)
            eigen_factors[eval_name][module_name] = saved["evals"].to(original.dtype)
            eigen_factors[evec_name][module_name] = saved["evecs"].to(original.dtype)
            continue
        pending.append((pair_idx, module_name, ckpt))

    def on_result(j: int, evals: torch.Tensor, evecs: torch.Tensor) -> None:
        pair_idx, module_name, ckpt = pending[j]
        cov_name, _count, evec_name, eval_name = _FACTOR_PAIRS[pair_idx]
        like = covariance_factors[cov_name][module_name]
        evals = evals.to(device=like.device, dtype=like.dtype)
        evecs = evecs.to(device=like.device, dtype=like.dtype)
        if ckpt is not None:
            tmp = ckpt.with_suffix(".tmp")
            save_file({"evals": evals, "evecs": evecs}, tmp)
            tmp.replace(ckpt)
        eigen_factors[eval_name][module_name] = evals
        eigen_factors[evec_name][module_name] = evecs

    eigh_large(
        [functools.partial(_normalized, covariance_factors, p, n) for p, n, _ in pending],
        on_result,
        solve=solve,
    )


def _cusolver_group(covariance_factors, eigen_factors, entries) -> None:
    """One batched `torch.linalg.eigh` over a group of one dimension."""
    mats, counts = [], []
    for (pair_idx, module_name), _dim in entries:
        cov_name, count_name = _FACTOR_PAIRS[pair_idx][:2]
        mats.append(covariance_factors[cov_name][module_name])
        counts.append(covariance_factors[count_name][module_name].reshape(()))
    evals, evecs = torch.linalg.eigh(_normalize_stacked(torch.stack(mats), torch.stack(counts)))
    for k, ((pair_idx, module_name), _dim) in enumerate(entries):
        _cov, _count, evec_name, eval_name = _FACTOR_PAIRS[pair_idx]
        dtype = mats[k].dtype
        eigen_factors[eval_name][module_name] = evals[k].to(dtype)
        eigen_factors[evec_name][module_name] = evecs[k].to(dtype)


def _jacobi_group(covariance_factors, eigen_factors, entries, target: int) -> None:
    """The JAX package's "jacobi" route for one merged group: one batched
    blocked-Jacobi solve; results in each covariance's dtype."""
    normalized, order = _assemble_group(covariance_factors, entries, target)
    evals, evecs = eigh_batched(normalized)
    for k, (pair_idx, module_name, dim) in enumerate(order):
        cov_name, _count, evec_name, eval_name = _FACTOR_PAIRS[pair_idx]
        ev, vec = _split_group_result(evals[k], evecs[k], dim)
        dtype = covariance_factors[cov_name][module_name].dtype
        eigen_factors[eval_name][module_name] = ev.to(dtype)
        eigen_factors[evec_name][module_name] = vec.to(dtype)


def _device_eigendecomposition(
    covariance_factors, eigen_factors, solver: str = "auto", scratch_dir=None
) -> None:
    """fp32 device path. "auto" / "qdwh": one batched `torch.linalg.eigh` per
    matrix dimension, across both factor families. "jacobi": the blocked
    Jacobi solver on the JAX package's merged dim groups. Either way a group
    of dimension >= LARGE_EIGH_DIM is solved one matrix at a time
    (`_large_group_eigendecomposition`, checkpointed in `scratch_dir`): with
    cuSOLVER under "auto" and "qdwh", with the host-loop Jacobi
    (`ops/eigh.py:jacobi_hostloop_solve`) under "jacobi", the JAX package's
    solve there. Results in each covariance's dtype."""
    if solver == "dc":
        raise NotImplementedError(
            "eigendecomposition_solver='dc' (kronfluence_tpu/ops/eigh_dc.py) is TPU-only and "
            "on ROADMAP's 'Not to port' list; use 'auto' or 'jacobi'."
        )
    if solver not in ("auto", "qdwh", "jacobi"):
        raise ValueError(f"Unknown eigendecomposition_solver {solver!r}.")
    if solver == "jacobi":
        groups = _merge_dim_groups(_dim_groups(covariance_factors))
        large_solve = jacobi_hostloop_solve
    else:
        groups = {
            dim: [(key, dim) for key in keys] for dim, keys in _dim_groups(covariance_factors).items()
        }
        large_solve = None
    log = get_logger("kronfluence_tpu_torch.factor.eigen", level=logging.INFO)
    log.info("eigendecomposition groups: %s", {t: len(e) for t, e in groups.items()})
    for target, entries in groups.items():
        log.info(
            "eigendecomposition group dim=%d (%d matrices): %s", target, len(entries),
            "per-matrix eigh_large" if target >= LARGE_EIGH_DIM else solver,
        )
        if target >= LARGE_EIGH_DIM:
            _large_group_eigendecomposition(
                covariance_factors, eigen_factors, entries, scratch_dir, large_solve
            )
        elif solver == "jacobi":
            _jacobi_group(covariance_factors, eigen_factors, entries, target)
        else:
            _cusolver_group(covariance_factors, eigen_factors, entries)


def _host_eigendecomposition(covariance_factors, eigen_factors, dtype_name) -> None:
    """Host LAPACK path in `dtype_name` (fp64 keeps the reference's numerics);
    results go back to each covariance's device and dtype."""
    dtype = resolve_dtype(dtype_name)
    for cov_name, count_name, evec_name, eval_name in _FACTOR_PAIRS:
        for module_name, original in covariance_factors[cov_name].items():
            count = float(covariance_factors[count_name][module_name].reshape(()).item())
            matrix = original.detach().to(device="cpu", dtype=dtype).numpy() / count
            matrix = 0.5 * (matrix + matrix.T)
            evals, evecs = np.linalg.eigh(matrix)
            like = dict(device=original.device, dtype=original.dtype)
            eigen_factors[eval_name][module_name] = torch.from_numpy(
                np.ascontiguousarray(evals)
            ).to(**like)
            eigen_factors[evec_name][module_name] = torch.from_numpy(
                np.ascontiguousarray(evecs)
            ).to(**like)


def _runs_on_device(dtype_name: str, factor: torch.Tensor) -> bool:
    """fp32 factors on a CUDA device take the device path; all else the host."""
    return dtype_name == "float32" and factor.device.type == "cuda"


def perform_eigendecomposition(
    covariance_factors: Dict[str, Dict[str, torch.Tensor]],
    factor_args: Optional[FactorArguments] = None,
    scratch_dir=None,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Eigendecomposes both covariance factors of every module.

    `scratch_dir` holds the per-matrix checkpoints of the factors of
    dimension >= LARGE_EIGH_DIM on the device path
    (`_large_group_eigendecomposition`)."""
    factor_args = factor_args or FactorArguments()
    dtype_name = canonical_dtype_name(factor_args.eigendecomposition_dtype)
    eigen_factors: Dict[str, Dict[str, Any]] = {
        name: {}
        for name in (
            ACTIVATION_EIGENVECTORS_NAME,
            ACTIVATION_EIGENVALUES_NAME,
            GRADIENT_EIGENVECTORS_NAME,
            GRADIENT_EIGENVALUES_NAME,
        )
    }
    first = next(iter(covariance_factors[ACTIVATION_COVARIANCE_MATRIX_NAME].values()))
    if _runs_on_device(dtype_name, first):
        _device_eigendecomposition(
            covariance_factors, eigen_factors, factor_args.eigendecomposition_solver, scratch_dir
        )
    else:
        _host_eigendecomposition(covariance_factors, eigen_factors, dtype_name)
    return eigen_factors


def _make_lambda_update(
    model, task, psg_dtype, lambda_dtype, sample, use_eigenbasis, iterative, loss_scale=None,
    remat=False,
):
    """Per-batch Lambda update, with the JAX package's three branches."""
    lambda_accum = accumulation_dtype(lambda_dtype)
    post_process = task.enable_post_process_per_sample_gradient

    def _squared_psg_sum(a_tok, g_tok):
        """Σ_b (per-sample grad)^2. `iterative` forms one sample's gradient at
        a time, so only one (out_dim, in_dim) gradient is ever held."""
        if not iterative:
            psg = psg_op(a_tok, g_tok, lambda_dtype)
            return psg.square().sum(dim=0).to(lambda_accum)
        acc = torch.zeros(
            (g_tok.shape[-1], a_tok.shape[-1]), dtype=lambda_accum, device=a_tok.device
        )
        for b in range(a_tok.shape[0]):
            psg = psg_op(a_tok[b : b + 1], g_tok[b : b + 1], lambda_dtype)[0]
            acc += psg.square().to(lambda_accum)
        return acc

    def _lambda_contribution(spec, name, activations, output_gradients, valid, q_a, q_g):
        """Σ_b (projected per-sample grad)^2 for one module, one batch."""
        if post_process or len(activations) > 1:
            # Shared layers sum per-sample gradients over uses BEFORE squaring,
            # and post-processing needs the raw gradient: materialize it.
            psg = None
            for a, dy in zip(activations, output_gradients):
                a_tok = activation_tokens_with_bias(spec, a, psg_dtype)
                g_tok = gradient_tokens(spec, dy, valid, psg_dtype)
                contrib = psg_op(a_tok, g_tok, psg_dtype)
                psg = contrib if psg is None else psg + contrib
            if post_process:
                psg = task.post_process_per_sample_gradient(name, psg)
            psg = psg.to(lambda_dtype)
            if use_eigenbasis:
                psg = torch.matmul(torch.matmul(q_g.T.to(lambda_dtype), psg), q_a.to(lambda_dtype))
            return psg.square().sum(dim=0).to(lambda_accum)
        # Fast path: rotate the token streams into the eigenbases first.
        total = None
        for a, dy in zip(activations, output_gradients):
            a_tok = activation_tokens_with_bias(spec, a, psg_dtype)
            g_tok = gradient_tokens(spec, dy, valid, psg_dtype)
            if use_eigenbasis:
                a_tok = torch.matmul(a_tok, q_a)
                g_tok = torch.matmul(g_tok, q_g)
            contrib = _squared_psg_sum(a_tok, g_tok)
            total = contrib if total is None else total + contrib
        return total

    def update(state, batch, valid, generator, q_a_all, q_g_all):
        forward = train_loss_forward(model, task, batch, sample, generator)
        _, captures = capture(
            model, forward, loss_scale=loss_scale, remat=remat, generator=generator
        )
        num_valid = valid.to(torch.int64).sum()
        for name, cap in captures.items():
            lam = state[name][LAMBDA_MATRIX_NAME]
            lam += _lambda_contribution(
                cap.spec, name, cap.activations, cap.output_gradients, valid,
                q_a_all.get(name), q_g_all.get(name),
            ).to(lam.dtype)
            state[name][NUM_LAMBDA_PROCESSED] += num_valid
        return state

    return update


def fit_lambda_matrices_with_loader(
    model: PreparedModel,
    task: Task,
    loader,
    factor_args: Optional[FactorArguments] = None,
    eigen_factors: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    tracked_names: Optional[Sequence[str]] = None,
    mesh=None,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Fits Lambda matrices (squared per-sample gradients in the eigenbasis).
    With a data `mesh`, each rank sums its own rows and one all-reduce at the
    end sums the ranks' matrices and counts in the accumulation dtype."""
    check_loader(mesh, loader)
    factor_args = factor_args or FactorArguments()
    model = with_tracked(model, tracked_names)
    device = model.device
    config = get_factor_config(factor_args.strategy)
    use_eigenbasis = config.requires_eigendecomposition_for_lambda
    psg_dtype = resolve_dtype(factor_args.per_sample_gradient_dtype)
    lambda_dtype = resolve_dtype(factor_args.lambda_dtype)
    lambda_accum = accumulation_dtype(lambda_dtype)
    sample = not factor_args.use_empirical_fisher

    if use_eigenbasis and eigen_factors is None:
        raise FactorsNotFoundError(
            f"Strategy {factor_args.strategy!r} requires eigendecomposition results "
            "for Lambda computations, but they were not provided."
        )
    try:
        first_batch, _ = probe_first(loader)
    except StopIteration:
        raise ValueError("Empty loader for lambda fitting.") from None
    specs = discover_stage_specs(model, task, first_batch)

    q_a_all, q_g_all = {}, {}
    if use_eigenbasis:
        for out, key in ((q_a_all, ACTIVATION_EIGENVECTORS_NAME), (q_g_all, GRADIENT_EIGENVECTORS_NAME)):
            for name, arr in eigen_factors[key].items():
                if name in specs:
                    out[name] = arr.to(device=device, dtype=psg_dtype)

    state = {
        name: {
            LAMBDA_MATRIX_NAME: torch.zeros(
                (spec.gradient_dim, spec.activation_dim), dtype=lambda_accum, device=device
            ),
            NUM_LAMBDA_PROCESSED: torch.zeros((), dtype=torch.int64, device=device),
        }
        for name, spec in specs.items()
    }

    model = cast_params(model, factor_args.amp_dtype)
    update = _make_lambda_update(
        model, task, psg_dtype, lambda_dtype, sample, use_eigenbasis,
        factor_args.use_iterative_lambda_aggregation,
        loss_scale_for(factor_args.amp_dtype, factor_args.amp_scale),
        factor_args.offload_activations_to_cpu,
    )
    generator = torch.Generator(device).manual_seed(factor_args.seed + 1) if sample else None
    for batch, valid in loader:
        update(state, batch, valid, generator, q_a_all, q_g_all)
    all_reduce_tree(mesh, state)

    result: Dict[str, Dict[str, torch.Tensor]] = {LAMBDA_MATRIX_NAME: {}, NUM_LAMBDA_PROCESSED: {}}
    for name, mod_state in state.items():
        result[LAMBDA_MATRIX_NAME][name] = mod_state[LAMBDA_MATRIX_NAME].to(lambda_dtype)
        result[NUM_LAMBDA_PROCESSED][name] = mod_state[NUM_LAMBDA_PROCESSED].reshape((1,))
    return result
