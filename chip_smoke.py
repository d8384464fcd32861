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
     and scores must agree.

It prints one JSON line with the kernels' results before the last line, and
ends with `{"ok": true, "device": {...}}`. Without a CUDA card, or when the
package is not beside this file, it exits non-zero without a result line.
"""

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


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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
    ms = float(np.median(host))
    log(f"K3 probe: exact; {ms:.4f} ms a call (host clock, launch + sync + check), "
        f"plain src+1 {plain_ms:.4f} ms (CUDA events)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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
                kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
                flops = 2.0 * rows * n * n  # full product; the kernel does ~half
                timing[(rows, n, dtype)] = (kernel_ms, plain_ms)
                line += (
                    f"; kernel {kernel_ms:.3f} ms ({k1:.3f}, {k2:.3f}), plain fp32 "
                    f"{plain_ms:.3f} ms ({p1:.3f}, {p2:.3f}), torch.matmul(flat.T, flat) in "
                    f"{str(dtype).split('.')[-1]} {mm:.3f} ms; kernel "
                    f"{flops / 2 / kernel_ms / 1e9:.1f} TFLOP/s on the triangle [{card}]"
                )
            log(line)
    kernel_ms, plain_ms = timing[(8192, 3072, torch.bfloat16)]
    return {"max_abs_err": worst, "ms": kernel_ms, "plain_ms": plain_ms}


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


def phase_main_path(card: str) -> dict:
    from kronfluence_tpu_torch.models.transformer import gpt2_small, init_transformer
    from kronfluence_tpu_torch.ops.kernels.probe import probe
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk
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
    torch.cuda.reset_peak_memory_stats()
    syrk.launches = 0
    probe.launches = 0
    cov, eigen, lam, scores, seconds = run_slice(
        model, task, data, factor_args, score_args, device,
        (COV_BATCH, LAMBDA_BATCH, QUERY_BATCH, TRAIN_BATCH),
    )
    launches = {"syrk": syrk.launches, "probe": probe.launches}
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
    return launches


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
    if not (REPO / "kronfluence_tpu_torch" / "__init__.py").exists():
        raise SystemExit("chip_smoke.py runs from a checkout: kronfluence_tpu_torch/ is missing.")
    sys.path.insert(0, str(REPO))
    card = phase_device()
    phase_build()
    probe_result = phase_probe()
    syrk_result = phase_syrk(card)
    launches = phase_main_path(card)
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
    ]
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
