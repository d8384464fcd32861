#!/usr/bin/env python3
"""Smoke run of kronfluence_tpu_torch's main path on one CUDA card.

Run from the root of a checkout, with no arguments: `python3 chip_smoke.py`.
It imports the port, torch and numpy only (no JAX), and runs these phases,
each of which raises on failure:

  1. device: requires a CUDA card, prints its name and power limit, turns
     TF32 off for fp32 matmuls and convolutions;
  2. build: compiles the hand-written kernels in kronfluence_tpu_torch/csrc/
     with nvcc (sm_90a) and loads them;
  3. K3 probe: the build-and-launch check against its plain version;
  4. K1 syrk: the triangle kernel against its plain version at the main
     path's gram shapes and at ragged ones, exact symmetry required, with
     median times beside `torch.matmul(flat.T, flat)`;
  5. main path: GPT-2 small at full width (vocab 50,257, 12 layers, 12
     heads, d 768, seq 512) in bf16 with random weights from a seeded
     generator, through covariance -> eigendecomposition -> lambda ->
     pairwise with the bf16 "smart low precision" EK-FAC recipe. Every
     kernel count is zeroed before and read after; K1 must launch 36 times
     per covariance batch;
  6. reference: a small fp32 GPT-2 runs the same slice on the card and on
     the CPU (plain versions, host LAPACK); covariances, eigenvalues, lambda
     and scores must agree;
  7. K2 jacobi: the pivot-rotation kernel against its plain version at the
     Jacobi path's launch shapes (m 64, Y 780 / 432 / 294), an odd Y, m 32,
     sweeps 1 and 2; median times beside `torch.linalg.eigh` on the same
     batch as a yardstick;
  8. Jacobi path: phase 5's covariance factors through
     `perform_eigendecomposition` with `eigendecomposition_solver="jacobi"`
     (K2 must launch once per blocked-Jacobi round: sweeps x rounds summed
     over chunks), then lambda and pairwise on that eigenbasis; the solver's
     fp32 eigenpairs are held against cuSOLVER's on all 96 matrices.

It prints one JSON line with the kernels' results before the last line, and
ends with `{"ok": true, "device": {...}}`. Without a CUDA card, or when the
package is not beside this file, it exits non-zero without a result line.

`python3 chip_smoke.py --profile-eigh` instead fits phase 5's covariance and
times the eigendecomposition stage with each solver (cuSOLVER, Jacobi,
Jacobi, cuSOLVER; the first of each is its first run in the process), then
profiles one more run of each with torch.profiler and prints their kernel
tables.
"""

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
SEQ = 512
COV_N, COV_BATCH = 64, 16
LAMBDA_N, LAMBDA_BATCH = 64, 16
QUERY_N, QUERY_BATCH = 16, 8
TRAIN_N, TRAIN_BATCH = 64, 16
QUERY_ACC = 2
# K1 operands on the main path: rows = batch x seq = 16 x 512; 2304 is the
# c_attn output gradient, 3072 the c_fc output gradient and the mlp/c_proj
# input activation. The ragged shapes exercise the masked edges.
SYRK_MAIN_SHAPES = ((8192, 2304), (8192, 3072))
SYRK_RAGGED_SHAPES = ((1000, 2000), (300, 1001))
# K1 vs its plain version: both sum exact fp32 products (bf16 x bf16 is exact
# in fp32) in fp32, in different orders, so the gap is a few fp32 ulps of the
# partial sums: |kernel - plain| <= 1e-4 * max|C| + 1e-4 * |plain|.
SYRK_RTOL = 1e-4
SYRK_ATOL_SCALE = 1e-4
# Small-input reference: the card (fp32 K1, device eigh) vs the CPU (plain
# versions, host LAPACK), on the same weights, data and eigenvectors. Both are
# fp32 with sums in different orders; the preconditioner (heuristic damping)
# amplifies those by its condition number, well under 1e3.
REFERENCE_RTOL = 1e-3
# K2 launch shapes of the Jacobi path (Y pivot blocks of m = 64), then an odd
# Y, m = 32 and one sweep. The kernel repeats the plain version's IEEE
# operations in the same order (explicitly rounded intrinsics, no FMA), so
# the two agree to 1e-5 (bit for bit, so far). 126 rounds of fp32 rotations
# leave V orthogonal to ~1e-5: limit 1e-4.
JACOBI_MAIN_Y = (780, 432, 294)
JACOBI_CASES = tuple((y, 64, 2) for y in JACOBI_MAIN_Y) + ((77, 64, 1), (300, 32, 2), (5, 32, 1))
JACOBI_ATOL = 1e-5
JACOBI_ORTH = 1e-4
# The Jacobi path's chunks (padded n, matrices), in solve order, for GPT-2
# small's merged groups 3073 (24 matrices), 2304 (12) and 769 (60), under the
# 64e6-element budget; and its limits against cuSOLVER, per matrix, relative to max|lambda|.
# The fine phase stops at a relative off-norm of max(1e-6, 8 eps sqrt(n)),
# 5.3e-5 at n = 3136, and the Rayleigh quotients are second order in it; the
# reconstruction is first order in the remaining off-diagonal, whose largest
# entry is far below its Frobenius norm; orthogonality is restored by one
# Newton-Schulz step. 1e-4 for each.
JACOBI_CHUNKS = [(3136, 6)] * 4 + [(2304, 12), (832, 60)]
JACOBI_EIG_RTOL = 1e-4
JACOBI_RECON_RTOL = 1e-4
JACOBI_ORTH_ATOL = 1e-4
# Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): the bounds in
# the kernels line are max(bytes / HBM rate, operations / peak rate).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def roofline(nbytes: float, ops: float, peak: float):
    """The least time (ms) the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak rate, and which it is."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops else "operations")


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("No CUDA device: chip_smoke.py runs the port on a GPU only.")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(
        f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}; "
        f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}"
    )
    return card


def phase_build() -> None:
    from kronfluence_tpu_torch.ops.kernels import build

    prebuilt = build.library_path().exists()
    t0 = time.perf_counter()
    build.build_library()
    built_s = time.perf_counter() - t0
    build.load_library()
    log(f"build: {'reused' if prebuilt else 'compiled'} {build.library_path().name} in {built_s:.2f} s")
    log_path = build.build_log_path()
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas: {line.split(':', 1)[-1].strip()}")


def phase_probe() -> dict:
    from kronfluence_tpu_torch.ops.kernels.probe import PROBE_SHAPE, probe, probe_reference

    src = torch.zeros(PROBE_SHAPE, dtype=torch.float32, device="cuda")
    got = probe("cuda")
    err = float((got - probe_reference(src)).abs().max())
    if err != 0.0:
        raise RuntimeError(f"K3 probe disagrees with src + 1: max |err| {err}")
    host = []
    for _ in range(20):
        t0 = time.perf_counter()
        probe("cuda")  # includes its own synchronize and check
        host.append((time.perf_counter() - t0) * 1e3)
    plain_ms = median_ms(lambda: probe_reference(src))
    library_ms = median_ms(lambda: torch.add(src, 1.0))
    ms = float(np.median(host))
    # 4 KB in, 4 KB out, 1,024 adds: the bound is far below one launch.
    bound_ms, bound_by = roofline(2 * src.numel() * 4, src.numel(), FP32_FLOPS)
    log(f"K3 probe: exact; {ms:.4f} ms a call (host clock, launch + sync + check), "
        f"plain src+1 {plain_ms:.4f} ms, torch.add {library_ms:.4f} ms (CUDA events), "
        f"bound {bound_ms:.2e} ms ({bound_by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def phase_syrk(card: str) -> dict:
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk, syrk_reference

    gen = torch.Generator("cuda").manual_seed(0)
    worst = 0.0
    timing = {}
    for rows, n in SYRK_MAIN_SHAPES + SYRK_RAGGED_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            a = torch.randn(rows, n, generator=gen, device="cuda").to(dtype)
            got = syrk(a)
            want = syrk_reference(a)
            torch.cuda.synchronize()
            if not torch.equal(got, got.T):
                raise RuntimeError(f"K1 result is not exactly symmetric at {rows}x{n} {dtype}")
            diff = (got - want).abs()
            bound = SYRK_ATOL_SCALE * want.abs().max() + SYRK_RTOL * want.abs()
            if not bool((diff <= bound).all()):
                raise RuntimeError(
                    f"K1 disagrees with its plain version at {rows}x{n} {dtype}: "
                    f"max |err| {float(diff.max()):.3e}, max |C| {float(want.abs().max()):.3e}"
                )
            err = float(diff.max())
            worst = max(worst, err)
            line = f"K1 {rows}x{n} {str(dtype).split('.')[-1]}: max |err| {err:.3e} " \
                   f"of max |C| {float(want.abs().max()):.3e}, symmetric"
            if (rows, n) in SYRK_MAIN_SHAPES:
                # Alternate plain, kernel, kernel, plain against drift.
                p1 = median_ms(lambda: syrk_reference(a))
                k1 = median_ms(lambda: syrk(a))
                k2 = median_ms(lambda: syrk(a))
                p2 = median_ms(lambda: syrk_reference(a))
                mm = median_ms(lambda: torch.matmul(a.T, a))
                # One library call with the same semantics (fp32 sums, fp32 out).
                lib = median_ms(lambda: torch.mm(a.T, a, out_dtype=torch.float32)) \
                    if dtype == torch.bfloat16 else mm
                kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
                # The lower triangle with its diagonal: rows x n(n+1)/2 dot
                # products; A read once, C written once.
                flops = float(rows) * n * (n + 1)
                peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
                bound, bound_by = roofline(rows * n * a.element_size() + n * n * 4, flops, peak)
                timing[(rows, n, dtype)] = (kernel_ms, plain_ms, bound, bound_by, lib)
                line += (
                    f"; kernel {kernel_ms:.3f} ms ({k1:.3f}, {k2:.3f}), plain fp32 "
                    f"{plain_ms:.3f} ms ({p1:.3f}, {p2:.3f}), torch.matmul(flat.T, flat) in "
                    f"{str(dtype).split('.')[-1]} {mm:.3f} ms, same-semantics library call "
                    f"{lib:.3f} ms; bound {bound:.4f} ms ({bound_by}); kernel "
                    f"{flops / kernel_ms / 1e9:.1f} TFLOP/s on the triangle [{card}]"
                )
            log(line)
    kernel_ms, plain_ms, bound, bound_by, lib = timing[(8192, 3072, torch.bfloat16)]
    return {"max_abs_err": worst, "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": lib}


def wikitext_style_task(num_layers: int):
    """The bench's task: summed token cross-entropy on fp32 logits under the
    attention mask, tracking the four projections of every block."""
    from kronfluence_tpu_torch.task import Task

    class WikitextStyleTask(Task):
        def compute_train_loss(self, batch, model, sample=False, generator=None):
            logits = model(batch["input_ids"], batch["attention_mask"])[:, :-1].float()
            mask = batch["attention_mask"][:, 1:].to(torch.float32)
            vocab = logits.shape[-1]
            if sample:
                probs = torch.softmax(logits.detach().reshape(-1, vocab), dim=-1)
                labels = torch.multinomial(probs, 1, generator=generator).reshape(mask.shape)
            else:
                labels = batch["input_ids"][:, 1:].long()
            losses = F.cross_entropy(
                logits.reshape(-1, vocab), labels.reshape(-1), reduction="none"
            ).reshape(mask.shape)
            return torch.sum(losses * mask)

        def compute_measurement(self, batch, model):
            return self.compute_train_loss(batch, model)

        def get_influence_tracked_modules(self):
            return [
                f"h_{i}/{name}"
                for i in range(num_layers)
                for name in ("attn/c_attn", "attn/c_proj", "mlp/c_fc", "mlp/c_proj")
            ]

        def get_attention_mask(self, batch):
            return batch["attention_mask"]

    return WikitextStyleTask()


def make_tokens(n: int, seq: int, vocab: int, seed: int, device) -> dict:
    """Synthetic tokens from a numpy seed, uploaded once (the bench's make_data)."""
    rng = np.random.default_rng(seed)
    host = {
        "input_ids": rng.integers(1, vocab, size=(n, seq)).astype(np.int32),
        "attention_mask": np.ones((n, seq), dtype=np.int32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def run_slice(model, task, data, factor_args, score_args, device, batches):
    """covariance -> eigendecomposition -> lambda -> pairwise; returns the
    artifacts and each stage's seconds (host clock, synchronized)."""
    from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
    from kronfluence_tpu_torch.factor.eigen import (
        fit_lambda_matrices_with_loader,
        perform_eigendecomposition,
    )
    from kronfluence_tpu_torch.score.pairwise import compute_pairwise_scores_with_loaders
    from kronfluence_tpu_torch.utils.dataset import BatchLoader

    cov_b, lam_b, query_b, train_b = batches

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    seconds = {}
    t0 = time.perf_counter()
    cov = fit_covariance_matrices_with_loader(
        model, task, BatchLoader(data["cov"], cov_b, device=device), factor_args
    )
    sync()
    seconds["covariance"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eigen = perform_eigendecomposition(cov, factor_args)
    sync()
    seconds["eigendecomposition"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lam = fit_lambda_matrices_with_loader(
        model, task, BatchLoader(data["lambda"], lam_b, device=device), factor_args,
        eigen_factors=eigen,
    )
    sync()
    seconds["lambda"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores = compute_pairwise_scores_with_loaders(
        model, task,
        BatchLoader(data["query"], query_b, device=device),
        BatchLoader(data["train"], train_b, device=device),
        {**cov, **eigen, **lam}, factor_args, score_args,
    )
    sync()
    seconds["pairwise"] = time.perf_counter() - t0
    return cov, eigen, lam, scores, seconds


def check_artifacts(cov, eigen, lam, scores, tokens_per_module, examples, score_shape) -> None:
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk_supported
    from kronfluence_tpu_torch.utils.constants import (
        ACTIVATION_COVARIANCE_MATRIX_NAME,
        ALL_MODULE_NAME,
        GRADIENT_COVARIANCE_MATRIX_NAME,
        NUM_ACTIVATION_COVARIANCE_PROCESSED,
        NUM_GRADIENT_COVARIANCE_PROCESSED,
        NUM_LAMBDA_PROCESSED,
    )

    for group in (cov, eigen, lam):
        for factor_name, per_module in group.items():
            for name, t in per_module.items():
                if not bool(torch.isfinite(t.float()).all()):
                    raise RuntimeError(f"non-finite {factor_name} for {name}")
    for factor_name in (ACTIVATION_COVARIANCE_MATRIX_NAME, GRADIENT_COVARIANCE_MATRIX_NAME):
        for name, c in cov[factor_name].items():
            if syrk_supported(c.shape[0], torch.float32) or syrk_supported(c.shape[0] - 1, torch.float32):
                # Sums of the kernel's exactly symmetric grams (plus the
                # symmetric bias border): exactly symmetric.
                if not torch.equal(c, c.T):
                    raise RuntimeError(f"{factor_name} of {name} is not exactly symmetric")
            else:
                gap = float((c.float() - c.float().T).abs().max())
                if gap > 1e-2 * float(c.float().abs().max()):
                    raise RuntimeError(f"{factor_name} of {name} is not symmetric (gap {gap})")
    for count_name in (NUM_ACTIVATION_COVARIANCE_PROCESSED, NUM_GRADIENT_COVARIANCE_PROCESSED):
        for name, count in cov[count_name].items():
            if int(count.item()) != tokens_per_module:
                raise RuntimeError(f"{count_name} of {name}: {int(count.item())} != {tokens_per_module}")
    for name, count in lam[NUM_LAMBDA_PROCESSED].items():
        if int(count.item()) != examples:
            raise RuntimeError(f"lambda count of {name}: {int(count.item())} != {examples}")
    got = scores[ALL_MODULE_NAME]
    if tuple(got.shape) != score_shape or not bool(torch.isfinite(got.float()).all()):
        raise RuntimeError(f"scores: shape {tuple(got.shape)} (want {score_shape}) or non-finite")


def setup_main_path() -> dict:
    """GPT-2 small at full width in bf16 with seeded random weights, the bench
    recipe, and the four stages' data, on cuda:0."""
    from kronfluence_tpu_torch.models.transformer import gpt2_small, init_transformer
    from kronfluence_tpu_torch.prepare import prepare_model
    from kronfluence_tpu_torch.utils.common.factor_arguments import (
        smart_low_precision_factor_arguments,
    )
    from kronfluence_tpu_torch.utils.common.score_arguments import (
        smart_low_precision_score_arguments,
    )

    device = torch.device("cuda", 0)
    config = gpt2_small(max_seq_len=SEQ, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    task = wikitext_style_task(config.num_layers)
    model = prepare_model(init_transformer(config, seed=0, device=device), task)
    torch.cuda.synchronize()
    log(f"main path: GPT-2 small bf16 ({sum(p.numel() for p in model.module.parameters()):,} "
        f"params) initialised in {time.perf_counter() - t0:.2f} s")

    factor_args = smart_low_precision_factor_arguments(strategy="ekfac")
    factor_args.use_empirical_fisher = True
    factor_args.eigendecomposition_dtype = "float32"
    score_args = smart_low_precision_score_arguments()
    score_args.query_gradient_storage_dtype = None
    score_args.query_gradient_accumulation_steps = QUERY_ACC

    data = {
        "cov": make_tokens(COV_N, SEQ, config.vocab_size, 1, device),
        "lambda": make_tokens(LAMBDA_N, SEQ, config.vocab_size, 3, device),
        "query": make_tokens(QUERY_N, SEQ, config.vocab_size, 5, device),
        "train": make_tokens(TRAIN_N, SEQ, config.vocab_size, 6, device),
    }
    return dict(model=model, task=task, data=data, factor_args=factor_args,
                score_args=score_args, device=device)


def phase_main_path(card: str) -> dict:
    from kronfluence_tpu_torch.ops.kernels.jacobi import jacobi_pivot_rotations
    from kronfluence_tpu_torch.ops.kernels.probe import probe
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk

    ctx = setup_main_path()
    model, task, data = ctx["model"], ctx["task"], ctx["data"]
    factor_args, score_args, device = ctx["factor_args"], ctx["score_args"], ctx["device"]
    torch.cuda.reset_peak_memory_stats()
    syrk.launches = probe.launches = jacobi_pivot_rotations.launches = 0
    cov, eigen, lam, scores, seconds = run_slice(
        model, task, data, factor_args, score_args, device,
        (COV_BATCH, LAMBDA_BATCH, QUERY_BATCH, TRAIN_BATCH),
    )
    launches = {"syrk": syrk.launches, "probe": probe.launches}
    if jacobi_pivot_rotations.launches:
        raise RuntimeError("K2 launched on the cuSOLVER path (eigendecomposition_solver='auto')")
    cov_batches = -(-COV_N // COV_BATCH)
    log(f"main path stage seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
        + f"; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    log(f"main path kernel launches: syrk {launches['syrk']} (want 36 x {cov_batches} "
        f"covariance batches = {36 * cov_batches}), probe {launches['probe']}")
    if launches["syrk"] != 36 * cov_batches:
        raise RuntimeError(f"K1 launched {launches['syrk']} times, want {36 * cov_batches}")
    if launches["probe"] < 1:
        raise RuntimeError("K3 was not launched on the main path")
    check_artifacts(cov, eigen, lam, scores, COV_N * SEQ, LAMBDA_N, (QUERY_N, TRAIN_N))
    from kronfluence_tpu_torch.utils.constants import ALL_MODULE_NAME

    s = scores[ALL_MODULE_NAME].float()
    log(f"main path: {len(cov['activation_covariance'])} modules; scores {tuple(s.shape)} "
        f"{scores[ALL_MODULE_NAME].dtype}, finite, |s| max {float(s.abs().max()):.4e}, "
        f"mean {float(s.mean()):.4e}")
    return dict(ctx, launches=launches, cov=cov, scores=scores)


def sym_blocks(y: int, m: int, seed: int) -> torch.Tensor:
    base = np.random.default_rng(seed).standard_normal((y, m, m)).astype(np.float32)
    return torch.from_numpy(base + base.transpose(0, 2, 1)).cuda()


def phase_jacobi_kernel(card: str) -> dict:
    from kronfluence_tpu_torch.ops.kernels.jacobi import (
        jacobi_pivot_rotations,
        jacobi_pivot_rotations_reference,
    )

    worst = 0.0
    timing = {}
    for y, m, sweeps in JACOBI_CASES:
        s = sym_blocks(y, m, seed=y * m + sweeps)
        got = jacobi_pivot_rotations(s, sweeps)
        want = jacobi_pivot_rotations_reference(s, sweeps)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        eye = torch.eye(m, device="cuda")
        orth = float((got.transpose(1, 2) @ got - eye).abs().max())

        def off_mass(v):
            d = v.transpose(1, 2) @ s @ v
            return float((d - d * eye).square().sum().sqrt() / (s - s * eye).square().sum().sqrt())

        ratio, plain_ratio = off_mass(got), off_mass(want)
        line = (f"K2 Y {y} m {m} sweeps {sweeps}: max |V - plain| {err:.3e}, bitwise equal "
                f"{bool(torch.equal(got, want))}, max |V^T V - I| {orth:.2e}, off-diagonal mass "
                f"ratio {ratio:.4f} (plain {plain_ratio:.4f})")
        if not (err <= JACOBI_ATOL and orth <= JACOBI_ORTH and ratio < 0.75
                and abs(ratio - plain_ratio) <= 1e-3 * plain_ratio):
            raise RuntimeError(f"K2 disagrees with its plain version: {line}")
        worst = max(worst, err)
        if y in JACOBI_MAIN_Y:
            p1 = median_ms(lambda: jacobi_pivot_rotations_reference(s, sweeps), iters=5, warmup=1)
            k1 = median_ms(lambda: jacobi_pivot_rotations(s, sweeps))
            k2 = median_ms(lambda: jacobi_pivot_rotations(s, sweeps))
            p2 = median_ms(lambda: jacobi_pivot_rotations_reference(s, sweeps), iters=5, warmup=1)
            eigh_ms = median_ms(lambda: torch.linalg.eigh(s), iters=5, warmup=1)
            rounds = sweeps * (m - 1)
            # Per round and block: rows, columns and V, 3 m^2 operations each;
            # the blocks read once and V written once.
            bound, bound_by = roofline(2 * y * m * m * 4, 9.0 * m * m * rounds * y, FP32_FLOPS)
            timing[y] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=bound,
                             bound_by=bound_by, eigh_ms=eigh_ms)
            line += (f"; kernel {(k1 + k2) / 2:.4f} ms ({k1:.4f}, {k2:.4f}), plain "
                     f"{(p1 + p2) / 2:.3f} ms ({p1:.3f}, {p2:.3f}), bound {bound:.4f} ms "
                     f"({bound_by}); yardstick torch.linalg.eigh on the same batch {eigh_ms:.3f} ms "
                     f"(exact pivots, the JAX package's pivot=\"eigh\", ops/eigh.py:467-475; "
                     f"not the same function) [{card}]")
        log(line)
    main = timing[JACOBI_MAIN_Y[0]]
    return {"max_abs_err": worst, "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
            "exact_pivot_eigh_ms": main["eigh_ms"],
            "by_launch_shape": {f"Y{y} m64 sweeps2": t for y, t in timing.items()}}


def _to_fp32(factors: dict) -> dict:
    return {k: {n: t.float() if t.is_floating_point() else t for n, t in v.items()}
            for k, v in factors.items()}


def _stage(fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def compare_eigenpairs(cov32: dict, got: dict, want: dict) -> dict:
    """Per matrix, relative to cuSOLVER's max|lambda|: max |dlambda|, max
    |Q L Q^T - A| for both solvers, and max |Q^T Q - I| of `got`."""
    from kronfluence_tpu_torch.factor.eigen import _FACTOR_PAIRS

    worst = {"eigenvalues": 0.0, "reconstruction": 0.0, "orthogonality": 0.0,
             "cusolver_reconstruction": 0.0}
    for cov_name, count_name, evec_name, eval_name in _FACTOR_PAIRS:
        for name, c in cov32[cov_name].items():
            a = c / cov32[count_name][name].float().reshape(())
            a = 0.5 * (a + a.T)
            lam, q = got[eval_name][name], got[evec_name][name]
            ref_lam, ref_q = want[eval_name][name], want[evec_name][name]
            scale = float(ref_lam.abs().max())
            eye = torch.eye(a.shape[0], device=a.device)
            worst["eigenvalues"] = max(worst["eigenvalues"], float((lam - ref_lam).abs().max()) / scale)
            worst["reconstruction"] = max(
                worst["reconstruction"], float(((q * lam) @ q.T - a).abs().max()) / scale)
            worst["cusolver_reconstruction"] = max(
                worst["cusolver_reconstruction"],
                float(((ref_q * ref_lam) @ ref_q.T - a).abs().max()) / scale)
            worst["orthogonality"] = max(worst["orthogonality"], float((q.T @ q - eye).abs().max()))
    return worst


def phase_jacobi_path(card: str, ctx: dict) -> int:
    from kronfluence_tpu_torch.factor.eigen import (
        fit_lambda_matrices_with_loader,
        perform_eigendecomposition,
    )
    from kronfluence_tpu_torch.ops.eigh import eigh_batched
    from kronfluence_tpu_torch.ops.kernels.jacobi import jacobi_pivot_rotations
    from kronfluence_tpu_torch.ops.kernels.probe import probe
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk
    from kronfluence_tpu_torch.score.pairwise import compute_pairwise_scores_with_loaders
    from kronfluence_tpu_torch.utils.constants import ALL_MODULE_NAME
    from kronfluence_tpu_torch.utils.dataset import BatchLoader

    model, task, data, cov = ctx["model"], ctx["task"], ctx["data"], ctx["cov"]
    device, score_args = ctx["device"], ctx["score_args"]
    jacobi_args = copy.deepcopy(ctx["factor_args"])
    jacobi_args.eigendecomposition_solver = "jacobi"

    torch.cuda.reset_peak_memory_stats()
    eigh_batched.chunks.clear()
    jacobi_pivot_rotations.launches = syrk.launches = probe.launches = 0
    eigen, eig_s = _stage(perform_eigendecomposition, cov, jacobi_args)
    launches = jacobi_pivot_rotations.launches
    eig_peak = torch.cuda.max_memory_allocated() / 2**30
    lam, lam_s = _stage(
        fit_lambda_matrices_with_loader, model, task,
        BatchLoader(data["lambda"], LAMBDA_BATCH, device=device), jacobi_args, eigen,
    )
    scores, pair_s = _stage(
        compute_pairwise_scores_with_loaders, model, task,
        BatchLoader(data["query"], QUERY_BATCH, device=device),
        BatchLoader(data["train"], TRAIN_BATCH, device=device),
        {**cov, **eigen, **lam}, jacobi_args, score_args,
    )
    chunks = list(eigh_batched.chunks)
    want = sum(c["sweeps"] * c["rounds_per_sweep"] for c in chunks)
    log(f"Jacobi path: eigendecomposition {eig_s:.3f} s (first Jacobi run in the process), "
        f"lambda {lam_s:.3f} s, pairwise {pair_s:.3f} s; peak device memory "
        f"{eig_peak:.2f} GiB in the eigendecomposition, "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB in all [{card}]")
    log("Jacobi path chunks (padded n, matrices, sweeps, rounds per sweep): "
        + ", ".join(f"({c['n']}, {c['matrices']}, {c['sweeps']}, {c['rounds_per_sweep']})" for c in chunks))
    log(f"Jacobi path kernel launches: jacobi {launches} (want sum of sweeps x rounds = {want}), "
        f"syrk {syrk.launches}, probe {probe.launches}")
    if [(c["n"], c["matrices"]) for c in chunks] != JACOBI_CHUNKS:
        raise RuntimeError(f"Jacobi path chunks {chunks}, want (n, matrices) {JACOBI_CHUNKS}")
    if launches != want or launches == 0:
        raise RuntimeError(f"K2 launched {launches} times on the Jacobi path, want {want}")
    check_artifacts(cov, eigen, lam, scores, COV_N * SEQ, LAMBDA_N, (QUERY_N, TRAIN_N))
    s_j = scores[ALL_MODULE_NAME].float().flatten()
    s_c = ctx["scores"][ALL_MODULE_NAME].float().flatten()
    pearson = float(torch.corrcoef(torch.stack([s_j, s_c]))[0, 1])
    log(f"Jacobi path: scores {tuple(scores[ALL_MODULE_NAME].shape)} finite; Pearson r against "
        f"the cuSOLVER path's scores {pearson:.6f} (EK-FAC fits lambda in the eigenbasis, and "
        f"the solvers pick different bases for close eigenvalues)")

    # Accuracy: the stage's fp32 eigenpairs (the bf16 recipe stores them in
    # bf16) from both solvers, on the same fp32 covariance factors.
    cov32 = _to_fp32(cov)
    auto_args = copy.deepcopy(jacobi_args)
    auto_args.eigendecomposition_solver = "auto"
    eigh_batched.chunks.clear()
    jacobi32, warm_s = _stage(perform_eigendecomposition, cov32, jacobi_args)
    cusolver32, cus_s = _stage(perform_eigendecomposition, cov32, auto_args)
    same = [(c["n"], c["sweeps"]) for c in eigh_batched.chunks] == [(c["n"], c["sweeps"]) for c in chunks]
    worst = compare_eigenpairs(cov32, jacobi32, cusolver32)
    log(f"Jacobi vs cuSOLVER, fp32, worst of 96 matrices: eigenvalues {worst['eigenvalues']:.3e} "
        f"(limit {JACOBI_EIG_RTOL:g}), reconstruction {worst['reconstruction']:.3e} (limit "
        f"{JACOBI_RECON_RTOL:g}; cuSOLVER's own {worst['cusolver_reconstruction']:.3e}), "
        f"orthogonality {worst['orthogonality']:.3e} (limit {JACOBI_ORTH_ATOL:g}); "
        f"stage seconds on fp32 factors: jacobi {warm_s:.3f} (second run, same sweeps as the "
        f"bf16 run: {same}), cuSOLVER {cus_s:.3f} [{card}]")
    if not (worst["eigenvalues"] <= JACOBI_EIG_RTOL and worst["reconstruction"] <= JACOBI_RECON_RTOL
            and worst["orthogonality"] <= JACOBI_ORTH_ATOL):
        raise RuntimeError(f"the Jacobi path's eigenpairs are off cuSOLVER's: {worst}")
    ground_truth(card, cov32, jacobi32, cusolver32)
    return launches


def ground_truth(card: str, cov32: dict, jacobi32: dict, cusolver32: dict) -> None:
    """Eigenvalues of both solvers against fp64 host LAPACK, relative to
    max|lambda|: four GPT-2 factors of width 769/768 from the Jacobi path, and
    three seeded 500 x 500 Wishart matrices (g g^T / 500, condition ~1e6)
    solved here. The Jacobi solver is held to 5e-5, the JAX package's bound
    against LAPACK (tests/test_eigh.py); cuSOLVER's error is printed."""
    from kronfluence_tpu_torch.ops.eigh import eigh_batched
    from kronfluence_tpu_torch.utils.constants import (
        ACTIVATION_COVARIANCE_MATRIX_NAME as ACT,
        ACTIVATION_EIGENVALUES_NAME as ACT_EVALS,
        GRADIENT_COVARIANCE_MATRIX_NAME as GRAD,
        GRADIENT_EIGENVALUES_NAME as GRAD_EVALS,
        NUM_ACTIVATION_COVARIANCE_PROCESSED as ACT_COUNT,
        NUM_GRADIENT_COVARIANCE_PROCESSED as GRAD_COUNT,
    )

    def rel(got, a):
        ref = np.linalg.eigh(a.double().cpu().numpy())[0]
        return float(np.abs(got.double().cpu().numpy() - ref).max() / np.abs(ref).max())

    rows = []
    for cov_name, count_name, eval_name, name in (
        (ACT, ACT_COUNT, ACT_EVALS, "h_0/attn/c_attn"),
        (ACT, ACT_COUNT, ACT_EVALS, "h_11/mlp/c_fc"),
        (GRAD, GRAD_COUNT, GRAD_EVALS, "h_0/attn/c_proj"),
        (GRAD, GRAD_COUNT, GRAD_EVALS, "h_11/mlp/c_proj"),
    ):
        a = cov32[cov_name][name] / cov32[count_name][name].float().reshape(())
        a = 0.5 * (a + a.T)
        rows.append((f"{name} {cov_name.split('_')[0]} {a.shape[0]}",
                     rel(jacobi32[eval_name][name], a), rel(cusolver32[eval_name][name], a)))
    g = np.random.default_rng(0).standard_normal((3, 500, 500)).astype(np.float32)
    wishart = torch.from_numpy(g @ g.transpose(0, 2, 1) / 500).cuda()
    jac, cus = eigh_batched(wishart)[0], torch.linalg.eigh(wishart)[0]
    for i in range(3):
        rows.append((f"Wishart 500 #{i}", rel(jac[i], wishart[i]), rel(cus[i], wishart[i])))
    log("eigenvalues vs fp64 host LAPACK, max |dlambda| / max |lambda|: " + "; ".join(
        f"{label}: jacobi {j:.2e}, cuSOLVER {c:.2e}" for label, j, c in rows) + f" [{card}]")
    bad = [label for label, j, _ in rows if not j <= 5e-5]
    if bad:
        raise RuntimeError(f"the Jacobi solver is off fp64 LAPACK by more than 5e-5 on {bad}")


def profile_eigh(card: str) -> None:
    """Cold and warm eigendecomposition seconds of both solvers on phase 5's
    covariance factors, and a torch.profiler kernel table of a warm run."""
    from torch.profiler import ProfilerActivity, profile

    from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
    from kronfluence_tpu_torch.factor.eigen import perform_eigendecomposition
    from kronfluence_tpu_torch.utils.dataset import BatchLoader

    ctx = setup_main_path()
    cov = fit_covariance_matrices_with_loader(
        ctx["model"], ctx["task"], BatchLoader(ctx["data"]["cov"], COV_BATCH, device=ctx["device"]),
        ctx["factor_args"],
    )
    args = {}
    for solver in ("auto", "jacobi"):
        args[solver] = copy.deepcopy(ctx["factor_args"])
        args[solver].eigendecomposition_solver = solver
    for solver in ("auto", "jacobi", "jacobi", "auto"):
        _, sec = _stage(perform_eigendecomposition, cov, args[solver])
        log(f"eigendecomposition {solver}: {sec:.4f} s [{card}]")
    for solver in ("auto", "jacobi"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, sec = _stage(perform_eigendecomposition, cov, args[solver])
        events = prof.key_averages()
        # Kernels only: an operator's self device time repeats its kernels'.
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in kernels)
        log(f"profiled eigendecomposition {solver}: {sec:.4f} s wall, kernel time "
            f"{device_us / 1e6:.4f} s, busy share {device_us / 1e6 / sec:.3f} [{card}]")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"  {e.self_device_time_total / 1e3:10.1f} ms {100 * e.self_device_time_total / device_us:5.1f}% "
                f"x{e.count:<6d} {e.key[:90]}")
        log(events.table(sort_by="self_cuda_time_total", row_limit=15))


def _max_rel(got: dict, want: dict) -> float:
    """max over modules of max|got - want| / max|want| (per-module scale)."""
    worst = 0.0
    for name, w in want.items():
        w = w.double().cpu()
        g = got[name].double().cpu()
        worst = max(worst, float((g - w).abs().max() / w.abs().max().clamp_min(1e-300)))
    return worst


def phase_reference() -> None:
    from kronfluence_tpu_torch.arguments import FactorArguments, ScoreArguments
    from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
    from kronfluence_tpu_torch.factor.eigen import (
        fit_lambda_matrices_with_loader,
        perform_eigendecomposition,
    )
    from kronfluence_tpu_torch.models.transformer import init_transformer, tiny_config
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk
    from kronfluence_tpu_torch.prepare import prepare_model
    from kronfluence_tpu_torch.score.pairwise import compute_pairwise_scores_with_loaders
    from kronfluence_tpu_torch.utils.constants import (
        ACTIVATION_COVARIANCE_MATRIX_NAME,
        ACTIVATION_EIGENVALUES_NAME,
        ALL_MODULE_NAME,
        GRADIENT_COVARIANCE_MATRIX_NAME,
        GRADIENT_EIGENVALUES_NAME,
        LAMBDA_MATRIX_NAME,
    )
    from kronfluence_tpu_torch.utils.dataset import BatchLoader

    # d_model 512: the c_fc gradient (2048) and mlp/c_proj activation (2048)
    # grams pass the K1 shape rule, so the card runs the fp32 kernel.
    config = tiny_config(
        vocab_size=512, max_seq_len=64, num_layers=2, num_heads=8, d_model=512,
        dtype=torch.float32,
    )
    task = wikitext_style_task(config.num_layers)
    factor_args = FactorArguments(
        strategy="ekfac", use_empirical_fisher=True, eigendecomposition_dtype="float32"
    )
    score_args = ScoreArguments(damping_factor=None, query_gradient_accumulation_steps=2)
    module = init_transformer(config, seed=0, device="cpu")
    host = {
        k: make_tokens(n, config.max_seq_len, config.vocab_size, seed, "cpu")
        for k, n, seed in (("cov", 32, 11), ("lambda", 32, 13), ("query", 8, 15), ("train", 24, 16))
    }
    out = {}
    eig_cpu = None
    for device in (torch.device("cpu"), torch.device("cuda", 0)):
        model = prepare_model(module.to(device), task)
        data = {k: {c: v.to(device) for c, v in cols.items()} for k, cols in host.items()}
        before = syrk.launches
        cov = fit_covariance_matrices_with_loader(
            model, task, BatchLoader(data["cov"], 8, device=device), factor_args
        )
        eig = perform_eigendecomposition(cov, factor_args)
        if eig_cpu is None:
            eig_cpu = eig
        # EK-FAC fits lambda in the eigenbasis, and the two solvers may pick
        # different bases for close eigenvalues: both sides take the CPU's
        # eigenvectors from here on, and the card's own are held by eigenvalue.
        shared = {k: {n: t.to(device) for n, t in v.items()} for k, v in eig_cpu.items()}
        lam = fit_lambda_matrices_with_loader(
            model, task, BatchLoader(data["lambda"], 8, device=device), factor_args,
            eigen_factors=shared,
        )
        scores = compute_pairwise_scores_with_loaders(
            model, task, BatchLoader(data["query"], 4, device=device),
            BatchLoader(data["train"], 8, device=device), {**cov, **shared, **lam},
            factor_args, score_args,
        )
        out[device.type] = (cov, eig, lam, scores, syrk.launches - before)
    cov_c, eig_c, lam_c, sc_c, _ = out["cpu"]
    cov_g, eig_g, lam_g, sc_g, k1_launches = out["cuda"]
    diffs = {
        "covariance": max(
            _max_rel(cov_g[k], cov_c[k])
            for k in (ACTIVATION_COVARIANCE_MATRIX_NAME, GRADIENT_COVARIANCE_MATRIX_NAME)
        ),
        "eigenvalues": max(
            _max_rel(eig_g[k], eig_c[k])
            for k in (ACTIVATION_EIGENVALUES_NAME, GRADIENT_EIGENVALUES_NAME)
        ),
        "lambda": _max_rel(lam_g[LAMBDA_MATRIX_NAME], lam_c[LAMBDA_MATRIX_NAME]),
        "scores": _max_rel(sc_g, sc_c),
    }
    log(
        "reference: small fp32 GPT-2, card vs CPU, max |diff| / max |ref|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
        + f" (limit {REFERENCE_RTOL:g}); K1 launches on the card side {k1_launches}; "
        f"scores {tuple(sc_g[ALL_MODULE_NAME].shape)}"
    )
    if k1_launches == 0:
        raise RuntimeError("the reference run did not reach K1 on the card")
    bad = {k: v for k, v in diffs.items() if not v <= REFERENCE_RTOL}
    if bad:
        raise RuntimeError(f"card disagrees with the CPU reference: {bad}")


def main() -> None:
    start = time.perf_counter()
    if not (REPO / "kronfluence_tpu_torch" / "__init__.py").exists():
        raise SystemExit("chip_smoke.py runs from a checkout: kronfluence_tpu_torch/ is missing.")
    sys.path.insert(0, str(REPO))
    card = phase_device()
    phase_build()
    if sys.argv[1:] == ["--profile-eigh"]:
        profile_eigh(card)
        return
    if sys.argv[1:]:
        raise SystemExit(f"usage: python3 chip_smoke.py [--profile-eigh]; got {sys.argv[1:]}")
    probe_result = phase_probe()
    syrk_result = phase_syrk(card)
    jacobi_result = phase_jacobi_kernel(card)
    ctx = phase_main_path(card)
    launches = dict(ctx["launches"], jacobi=phase_jacobi_path(card, ctx))
    del ctx
    phase_reference()
    kernels = [
        {
            "name": "syrk",
            "route": "cuda",
            "source": "kronfluence_tpu_torch/csrc/syrk.cu",
            "replaces": "kronfluence_tpu/ops/pallas/syrk.py:44",
            "launches": launches["syrk"],
            **syrk_result,
        },
        {
            "name": "probe",
            "route": "cuda",
            "source": "kronfluence_tpu_torch/csrc/probe.cu",
            "replaces": "kronfluence_tpu/utils/platform.py:55",
            "launches": launches["probe"],
            **probe_result,
        },
        {
            "name": "jacobi",
            "route": "cuda",
            "source": "kronfluence_tpu_torch/csrc/jacobi.cu",
            "replaces": "kronfluence_tpu/ops/pallas/jacobi.py:66",
            "launches": launches["jacobi"],
            **jacobi_result,
        },
    ]
    log(f"chip_smoke.py: all phases passed in {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
