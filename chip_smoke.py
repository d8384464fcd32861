#!/usr/bin/env python3
"""Smoke run of kronfluence_tpu_torch's main path on one CUDA card.

Run from the root of a checkout, with no arguments: `python3 chip_smoke.py`.
It imports the port, torch and numpy only (no JAX), and runs these phases,
each of which raises on failure:

  1. device: requires a CUDA card, prints its name and power limit, turns
     TF32 off for fp32 matmuls and convolutions;
  2. build: compiles the hand-written kernels in kronfluence_tpu_torch/csrc/
     with nvcc (sm_90a; one object per source, each source whose object is
     missing compiled in its own process, all started together; one link)
     and loads them; the wgmma syrk kernel's SASS must hold HGMMA and
     UTMALDG (cuobjdump);
  3. K3 probe: the build-and-launch check against its plain version, timed
     like for like: launch + synchronize + exactness check against
     torch.add + synchronize + the same check on the host clock, and the bare
     launch against torch.add with CUDA events;
  4. K1 syrk: the triangle kernels against their plain version at the main
     path's gram shapes and at ragged ones, in bf16 and fp32, and on a
     positive-mean bf16 input (|normal|) at the main shapes; exact symmetry
     required; the bf16 route (wgmma with TMA, or wmma) checked at each shape
     by the rule and the launch counter; a planted fault (the plain version
     with one 64-row slab left out) must read above the limit at each main
     shape; median times beside the library call and the bound;
  5. main path: GPT-2 small at full width (vocab 50,257, 12 layers, 12
     heads, d 768, seq 512) in bf16 with random weights from a seeded
     generator, through covariance -> eigendecomposition -> lambda ->
     pairwise with the bf16 "smart low precision" EK-FAC recipe and the naive
     attention form. Every kernel count is zeroed before and read after; K1
     must launch 36 times per covariance batch, all on the wgmma kernel,
     F1-F3 never;
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
     fp32 eigenpairs are held against cuSOLVER's on all 96 matrices;
  9. flash kernels: F1 (forward), F2 (dK, dV) and F3 (dQ) against their
     plain versions at every position of O, dQ, dK, dV: at the flash path's
     shape (B 16, H 12, T 512, D 64, bf16, padded mask), at D 128 and 256 in
     bf16, in fp32 at D 64, and at T 128 without padding; FB (the fused
     backward, dQ, dK and dV in one launch) against its plain version at the
     bf16 D 64 cases, where `backward_route` takes it; median times beside
     the plain versions, F.scaled_dot_product_attention (the library
     yardstick; for FB its backward alone), the naive form and the bound, and
     FB against F2+F3 in turns;
 10. flash path: phase 5's model, weights and data with attention="flash"
     through all four stages, scoring with fp8 (e4m3fn) query blocks and the
     auto-sized query block (`query_gradient_accumulation_steps=None`). F1
     must launch 12 times per model forward (passes and discovery forwards),
     FB 12 times per forward+backward pass, F2 and F3 and the naive form
     never, K1 36 times per covariance batch on the wgmma kernel; the
     covariance factors are held against phase 5's and the scores' Pearson r
     against phase 5's bf16 scores; covariance and lambda are timed in turns
     with the naive form and with the backward on each route;
 11. reference, flash: phase 6 again with attention="flash" (head_dim 64,
     T 128, padded data), in fp32: F1, F2 and F3 (the split route) on the
     card, FB never, their plain versions on the CPU.

It prints one JSON line with the kernels' results before the last line, and
ends with `{"ok": true, "device": {...}}`. Without a CUDA card, or when the
package is not beside this file, it exits non-zero without a result line.

`python3 chip_smoke.py --profile-eigh` instead fits phase 5's covariance and
times the eigendecomposition stage with each solver (cuSOLVER, Jacobi,
Jacobi, cuSOLVER; the first of each is its first run in the process), then
profiles one more run of each with torch.profiler and prints their kernel
tables.

`python3 chip_smoke.py --profile-k1` instead times phase 5's covariance
stage (cold, then warm), profiles one more warm run with torch.profiler (K1's
device time and share, the device's busy share), and times the wgmma syrk
kernel as built (kStages 4, one CTA an SM) in turns against copies of
csrc/syrk.cu built alone with kStages 3 (two CTAs an SM, and one) and, for
timing only, one whose every tile loads a single stripe as a diagonal tile
does (its results are wrong; it shows what the stripe loads cost).

`python3 chip_smoke.py --profile-flash` instead times FB as built (64-key
tile, 4 warps) in turns against copies of csrc/flash_backward.cu built alone
with a 128-key tile (held to the same bf16 limit first) and, for timing only,
without the dQ atomics (its dQ is wrong; it shows what the atomics cost),
against F2+F3 and against the wrapper's zeroing and cast of the fp32 dQ sum
alone, at the flash path's shape.
"""

import copy
import ctypes
import json
import re
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
# The bf16 kernel each shape must take: TMA describes n % 8 == 0 (torch's
# allocations are 16-byte aligned); 1001 columns take the wmma kernel.
SYRK_BF16_ROUTES = {(8192, 2304): "wgmma", (8192, 3072): "wgmma", (1000, 2000): "wgmma",
                    (300, 1001): "wmma"}
# The planted fault: the plain version without these rows, one 64-row slab
# (one ring stage of the wgmma kernel) of the main shapes' 8,192.
SYRK_FAULT_ROWS = (4096, 4160)
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
# F1-F3 against their plain versions, which share the kernels' semantics, at
# every position of O, dQ, dK and dV. In bf16 the kernels round P (and dS) to
# bf16 against the running row max while the plain version rounds against the
# final one, sum in another order, and both round the outputs to bf16: each
# element is off by a few bf16 unit roundoffs (u = 2^-8) of its own row's
# scale, a row being one query's D values of O and dQ and one key's of dK and
# dV. So a bf16 error is counted in units of u (|plain| + max |plain| of its
# row) + u^2 max |plain| (the floor covers rows that are zero in exact
# arithmetic: query 0 sees only key 0, so its dQ is fp32 noise), limit 8
# units. The same check on the plain version with one 64 x 64 block of P left
# out, what a kernel that skipped one tile would return, must read above the
# limit for each of O, dQ, dK and dV at the flash path's shape. In fp32 the
# sums run in another order: 1e-5 of the largest plain value. The row
# statistics l and m are fp32 on both sides: 1e-5.
FLASH_BF16_UNITS = 8.0
FLASH_FP32_TOL = 1e-5
FLASH_STATS_TOL = 1e-5
# The planted fault's block (query rows, key columns), below the diagonal at
# T 512: 64 of the 385-448 keys those rows see.
FLASH_FAULT_BLOCK = (slice(384, 448), slice(192, 256))
# (B, H, T, D, dtype, padded): the flash path's shape first.
FLASH_CASES = (
    (16, 12, 512, 64, torch.bfloat16, True),
    (8, 12, 512, 128, torch.bfloat16, True),
    (4, 8, 512, 256, torch.bfloat16, True),
    (8, 12, 512, 64, torch.float32, True),
    (16, 12, 128, 64, torch.bfloat16, False),
)
# The flash path against phase 5's naive path, same bf16 weights and data. The
# two forms round differently in bf16 (fp32 softmax and P rounded before P V,
# against bf16 scores and probabilities), a few bf16 steps per attention
# output, carried through 12 layers into the covariance sums: limit 5e-2 of
# each factor's max|C|. Scores: fp8 query blocks against phase 5's bf16 dense
# blocks, Pearson r at least 0.97, the JAX package's weakest fp8 certificate.
FLASH_FACTOR_RTOL = 5e-2
FLASH_PEARSON_MIN = 0.97


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


def device_ms(fn, names=None, calls: int = 20) -> float:
    """Device time per call of the kernels whose names hold one of `names`,
    or of every kernel the call launches (torch.profiler's CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and (names is None or any(n in e.key for n in names)))
    return us / calls / 1e3


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
    compiled = [src for src in build.SOURCES if not build.object_path(src).exists()]
    t0 = time.perf_counter()
    build.build_library()
    built_s = time.perf_counter() - t0
    build.load_library()
    log(f"build: {'reused' if prebuilt else 'linked'} {build.library_path().name} in "
        f"{built_s:.2f} s; compiled {compiled or 'nothing'}, reused the objects of "
        f"{[src for src in build.SOURCES if src not in compiled] or 'nothing'}")
    log_path = build.build_log_path()
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if line.startswith("== ") or "Compiling entry" in line:
                log(f"  {line.split(':', 1)[-1].strip()}")
            elif "Used" in line or "spill" in line:
                log(f"    ptxas: {line.split(':', 1)[-1].strip()}")
    counts = sass_counts(build.library_path(), "syrk_bf16_wgmma_kernel", ("HGMMA", "UTMALDG"))
    log(f"SASS of syrk_bf16_wgmma_kernel: {counts}")
    if not all(counts.values()):
        raise RuntimeError(f"the wgmma syrk kernel lacks wgmma or TMA instructions: {counts}")


def sass_counts(library: Path, kernel: str, opcodes) -> dict:
    """How often each opcode appears in `kernel`'s SASS in the library."""
    from kronfluence_tpu_torch.ops.kernels import build

    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    body = "".join(part for part in re.split(r"\n\s*Function : ", sass)
                   if kernel in part.split("\n", 1)[0])
    return {op: body.count(op) for op in opcodes}


def phase_probe() -> dict:
    from kronfluence_tpu_torch.ops.kernels.build import load_library
    from kronfluence_tpu_torch.ops.kernels.probe import (
        PROBE_SHAPE,
        launch_probe,
        probe,
        probe_reference,
    )

    src = torch.zeros(PROBE_SHAPE, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    got = probe("cuda")
    err = float((got - probe_reference(src)).abs().max())
    if err != 0.0:
        raise RuntimeError(f"K3 probe disagrees with src + 1: max |err| {err}")

    def library_checked():
        out = torch.add(src, 1.0)
        torch.cuda.synchronize()
        if not bool(torch.all(out == 1.0)):
            raise RuntimeError("torch.add(src, 1) returned wrong values")

    def host_median(fn) -> float:
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    # Like for like on the host clock: each call launches, synchronizes and
    # checks every element. Then the bare launches with CUDA events.
    lib = load_library()
    host_ms = host_median(lambda: probe("cuda"))
    library_host_ms = host_median(library_checked)
    ms = median_ms(lambda: launch_probe(lib, src, dst))
    plain_ms = median_ms(lambda: probe_reference(src))
    library_ms = median_ms(lambda: torch.add(src, 1.0))
    # 4 KB in, 4 KB out, 1,024 adds: the bound is far below one launch.
    bound_ms, bound_by = roofline(2 * src.numel() * 4, src.numel(), FP32_FLOPS)
    log(f"K3 probe: exact; host clock (launch + sync + check): probe {host_ms:.4f} ms, "
        f"torch.add {library_host_ms:.4f} ms; CUDA events (bare launch): K3 {ms:.4f} ms, "
        f"plain src+1 {plain_ms:.4f} ms, torch.add {library_ms:.4f} ms; "
        f"bound {bound_ms:.2e} ms ({bound_by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "host_ms": host_ms,
            "library_host_ms": library_host_ms}


def syrk_units(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in units of its limit, SYRK_ATOL_SCALE max|want|
    + SYRK_RTOL |want|: the check passes at <= 1."""
    bound = SYRK_ATOL_SCALE * want.abs().max() + SYRK_RTOL * want.abs()
    return float(((got - want).abs() / bound).max())


def phase_syrk(card: str) -> dict:
    from kronfluence_tpu_torch.ops.kernels.syrk import (
        TILE,
        bf16_route,
        syrk,
        syrk_reference,
        triangle_tiles,
        wgmma_smem_bytes,
    )

    gen = torch.Generator("cuda").manual_seed(0)
    smem = wgmma_smem_bytes()
    worst = 0.0
    timing = {}
    cases = []
    for rows, n in SYRK_MAIN_SHAPES + SYRK_RAGGED_SHAPES:
        cases += [(rows, n, torch.bfloat16, "normal"), (rows, n, torch.float32, "normal")]
        if (rows, n) in SYRK_MAIN_SHAPES:
            cases.append((rows, n, torch.bfloat16, "|normal|"))
    for rows, n, dtype, kind in cases:
        a = torch.randn(rows, n, generator=gen, device="cuda")
        a = (a.abs() if kind == "|normal|" else a).to(dtype)
        name = f"{rows}x{n} {str(dtype).split('.')[-1]} {kind}"
        before = syrk.wgmma_launches
        got = syrk(a)
        want = syrk_reference(a)
        torch.cuda.synchronize()
        if dtype == torch.bfloat16:
            route = "wgmma" if syrk.wgmma_launches == before + 1 else "wmma"
            if not route == bf16_route(n, a.data_ptr()) == SYRK_BF16_ROUTES[(rows, n)]:
                raise RuntimeError(f"K1 at {name} took {route}; the rule says "
                                   f"{bf16_route(n, a.data_ptr())}, want {SYRK_BF16_ROUTES[(rows, n)]}")
            tiles = triangle_tiles(n, TILE)
            route += f" ({tiles} tiles" + (f", {smem} B dynamic smem)" if route == "wgmma" else ")")
        else:
            route = f"fma ({triangle_tiles(n, 64)} tiles of 64)"
        if not torch.equal(got, got.T):
            raise RuntimeError(f"K1 result is not exactly symmetric at {name}")
        units = syrk_units(got, want)
        err = float((got - want).abs().max())
        if not units <= 1.0:
            raise RuntimeError(
                f"K1 disagrees with its plain version at {name}: {units:.3f} units of the "
                f"limit, max |err| {err:.3e}, max |C| {float(want.abs().max()):.3e}"
            )
        worst = max(worst, err)
        line = (f"K1 {name}: {route}; max |err| {err:.3e} of max |C| "
                f"{float(want.abs().max()):.3e}, {units:.4f} units of the limit, symmetric")
        if (rows, n) in SYRK_MAIN_SHAPES and dtype == torch.bfloat16:
            r0, r1 = SYRK_FAULT_ROWS
            fault = syrk_units(syrk_reference(torch.cat([a[:r0], a[r1:]])), want)
            if not fault > 1.0:
                raise RuntimeError(f"the planted fault (rows {r0}-{r1 - 1} left out) reads "
                                   f"{fault:.3f} units at {name}: the limit cannot see it")
            line += f"; planted fault (rows {r0}-{r1 - 1} left out) {fault:.2f} units"
        if (rows, n) in SYRK_MAIN_SHAPES and kind == "normal":
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
                f"; kernel {kernel_ms:.4f} ms ({k1:.4f}, {k2:.4f}), plain fp32 "
                f"{plain_ms:.3f} ms ({p1:.3f}, {p2:.3f}), torch.matmul(flat.T, flat) in "
                f"{str(dtype).split('.')[-1]} {mm:.4f} ms, same-semantics library call "
                f"{lib:.4f} ms; bound {bound:.4f} ms ({bound_by}); kernel "
                f"{flops / kernel_ms / 1e9:.1f} TFLOP/s on the triangle [{card}]"
            )
        log(line)

    def fields(key):
        kernel_ms, plain_ms, bound, bound_by, lib = timing[key]
        return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                "library_ms": lib}

    return {"max_abs_err": worst, **fields((8192, 3072, torch.bfloat16)),
            "timings_ms": {f"{rows}x{n}": fields((rows, n, torch.bfloat16))
                           for rows, n in SYRK_MAIN_SHAPES},
            "tiles": triangle_tiles(3072, TILE), "smem_bytes": smem}


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


def make_tokens(n: int, seq: int, vocab: int, seed: int, device, padded: bool = False) -> dict:
    """Synthetic tokens from a numpy seed, uploaded once (the bench's make_data);
    `padded` masks the tail of every other example."""
    rng = np.random.default_rng(seed)
    host = {
        "input_ids": rng.integers(1, vocab, size=(n, seq)).astype(np.int32),
        "attention_mask": np.ones((n, seq), dtype=np.int32),
    }
    if padded:
        for i in range(1, n, 2):
            host["attention_mask"][i, seq - seq // 4 - i % (seq // 4):] = 0
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


def flash_kernels():
    from kronfluence_tpu_torch.ops.kernels.flash import (
        flash_backward,
        flash_backward_dkv,
        flash_backward_dq,
        flash_forward,
    )

    return {"F1": flash_forward, "F2": flash_backward_dkv, "F3": flash_backward_dq,
            "FB": flash_backward}


def phase_main_path(card: str) -> dict:
    from kronfluence_tpu_torch.ops.attention import naive_attention
    from kronfluence_tpu_torch.ops.kernels.jacobi import jacobi_pivot_rotations
    from kronfluence_tpu_torch.ops.kernels.probe import probe
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk

    ctx = setup_main_path()
    model, task, data = ctx["model"], ctx["task"], ctx["data"]
    factor_args, score_args, device = ctx["factor_args"], ctx["score_args"], ctx["device"]
    torch.cuda.reset_peak_memory_stats()
    syrk.launches = syrk.wgmma_launches = probe.launches = jacobi_pivot_rotations.launches = 0
    for fn in flash_kernels().values():
        fn.launches = 0
    naive_attention.calls = 0
    cov, eigen, lam, scores, seconds = run_slice(
        model, task, data, factor_args, score_args, device,
        (COV_BATCH, LAMBDA_BATCH, QUERY_BATCH, TRAIN_BATCH),
    )
    launches = {"syrk": syrk.launches, "probe": probe.launches}
    wgmma_launches = syrk.wgmma_launches
    naive_calls = naive_attention.calls
    if jacobi_pivot_rotations.launches:
        raise RuntimeError("K2 launched on the cuSOLVER path (eigendecomposition_solver='auto')")
    if any(fn.launches for fn in flash_kernels().values()) or naive_calls == 0:
        raise RuntimeError("the main path (attention='naive') launched a flash kernel or "
                           "never ran the naive form")
    cov_batches = -(-COV_N // COV_BATCH)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"main path stage seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
        + f"; peak device memory {peak:.2f} GiB; naive attention calls {naive_calls}, "
        f"flash launches 0 [{card}]")
    log(f"main path kernel launches: syrk {launches['syrk']}, {wgmma_launches} of them the "
        f"wgmma kernel (want 36 x {cov_batches} covariance batches = {36 * cov_batches}, all "
        f"wgmma), probe {launches['probe']}")
    if not launches["syrk"] == wgmma_launches == 36 * cov_batches:
        raise RuntimeError(f"K1 launched {launches['syrk']} times, {wgmma_launches} on the "
                           f"wgmma kernel; want {36 * cov_batches}, all wgmma")
    if launches["probe"] < 1:
        raise RuntimeError("K3 was not launched on the main path")
    check_artifacts(cov, eigen, lam, scores, COV_N * SEQ, LAMBDA_N, (QUERY_N, TRAIN_N))
    from kronfluence_tpu_torch.utils.constants import ALL_MODULE_NAME

    s = scores[ALL_MODULE_NAME].float()
    log(f"main path: {len(cov['activation_covariance'])} modules; scores {tuple(s.shape)} "
        f"{scores[ALL_MODULE_NAME].dtype}, finite, |s| max {float(s.abs().max()):.4e}, "
        f"mean {float(s.mean()):.4e}")
    return dict(ctx, launches=launches, cov=cov, scores=scores, seconds=seconds, peak=peak)


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


def padded_segments(b: int, t: int, padded: bool, device) -> torch.Tensor:
    """int32 (B, T) segment ids: example i keeps T - (37 i mod T/2) tokens."""
    seg = torch.ones(b, t, dtype=torch.int32, device=device)
    if padded:
        for i in range(b):
            seg[i, t - (37 * i) % (t // 2):] = 0
    return seg


def flash_work(seg: torch.Tensor, heads: int, d: int, itemsize: int):
    """(query-key pairs the mask keeps, F1 / F2 / F3 / FB bytes and FLOPs) of
    one call: every operand read once and every output written once (FB's dQ
    in the operands' type, as the function returns it; the fp32 sum FB adds
    into is its design's cost, not the function's); QK^T and P V take 4 D FLOPs a kept pair
    (F1), F2 8 D (S^T, dP^T, dV, dK), F3 6 D (S, dP, dQ), FB 10 D (S, dP, dV,
    dK, dQ, each once)."""
    b, t = seg.shape
    causal = torch.ones(t, t, dtype=torch.bool, device=seg.device).tril()
    pairs = heads * int((causal & (seg[:, :, None] == seg[:, None, :])).sum())
    block = b * heads * t * d * itemsize  # one (B, H, T, D) operand
    stat = b * heads * t * 4  # one fp32 (B, H, T) statistic
    segb = b * t * 4
    return pairs, {
        "F1": (3 * block + block + 2 * stat + segb, 4.0 * d * pairs),
        "F2": (4 * block + 3 * stat + segb + 2 * block, 8.0 * d * pairs),
        "F3": (4 * block + 3 * stat + segb + block, 6.0 * d * pairs),
        "FB": (4 * block + 3 * stat + segb + 3 * block, 10.0 * d * pairs),
    }


def bf16_units(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (u (|want| + max |want| of its row) + u^2 max |want|), u = 2^-8."""
    got, want = got.float(), want.float()
    size = want.abs()
    unit = 2.0 ** -8 * (size + size.amax(-1, keepdim=True)) + 2.0 ** -16 * size.max()
    return float(((got - want).abs() / unit).max())


def relative_to_max(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def dropped_block(q, k, v, seg, l, m, do, di, scale, block) -> dict:
    """The plain O, dQ, dK and dV with one block of P (query rows, key
    columns) left out: what a kernel that skipped one tile would return. The
    forward renormalises without the block; the backward keeps the sound
    run's l and m, as F2 and F3 take them."""
    from kronfluence_tpu_torch.ops.kernels.flash import MASK_VALUE

    f, t = torch.float32, q.shape[2]
    keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    keep = (keep & (seg[:, :, None] == seg[:, None, :]))[:, None].clone()
    keep[:, :, block[0], block[1]] = False
    s = torch.matmul(q.to(f), k.to(f).transpose(-1, -2)) * scale
    s = torch.where(keep, s, s + MASK_VALUE)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.matmul(p.to(v.dtype).to(f), v.to(f)) / p.sum(-1, keepdim=True)
    p = torch.exp(s - m[..., None]) / l[..., None]
    dv = torch.matmul(p.to(do.dtype).to(f).transpose(-1, -2), do.to(f))
    ds = p * (torch.matmul(do.to(f), v.to(f).transpose(-1, -2)) - di[..., None]) * scale
    ds = ds.to(q.dtype).to(f)
    dk = torch.matmul(ds.transpose(-1, -2), q.to(f))
    dq = torch.matmul(ds, k.to(f))
    return {name: x.to(q.dtype) for name, x in (("O", o), ("dQ", dq), ("dK", dk), ("dV", dv))}


def phase_flash_kernels(card: str) -> dict:
    from kronfluence_tpu_torch.ops.attention import FlashAttention, naive_attention, output_dot
    from kronfluence_tpu_torch.ops.kernels.flash import (
        backward_route,
        flash_backward,
        flash_backward_dkv,
        flash_backward_dkv_reference,
        flash_backward_dq,
        flash_backward_dq_reference,
        flash_backward_reference,
        flash_forward,
        flash_forward_reference,
    )

    abs_errs = {"F1": 0.0, "F2": 0.0, "F3": 0.0, "FB": 0.0}
    owner = {"O": "F1", "dK": "F2", "dV": "F2", "dQ": "F3",
             "FB dQ": "FB", "FB dK": "FB", "FB dV": "FB"}
    for b, h, t, d, dtype, padded in FLASH_CASES:
        gen = torch.Generator("cuda").manual_seed(b * t + d)
        q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        seg = padded_segments(b, t, padded, "cuda")
        scale = d ** -0.5
        o, l, m = flash_forward(q, k, v, seg, scale)
        di = output_dot(o, do)
        dk, dv = flash_backward_dkv(q, k, v, seg, l, m, do, di, scale)
        dq = flash_backward_dq(q, k, v, seg, l, m, do, di, scale)
        ro, rl, rm = flash_forward_reference(q, k, v, seg, scale)
        rdk, rdv = flash_backward_dkv_reference(q, k, v, seg, l, m, do, di, scale)
        rdq = flash_backward_dq_reference(q, k, v, seg, l, m, do, di, scale)
        got = {"O": o, "dQ": dq, "dK": dk, "dV": dv}
        want = {"O": ro, "dQ": rdq, "dK": rdk, "dV": rdv}
        fused = backward_route(dtype, d) == "fused"
        if fused:
            # FB against its own plain version (computed on the same inputs).
            for name, x, y in zip(("dQ", "dK", "dV"),
                                  flash_backward(q, k, v, seg, l, m, do, di, scale),
                                  flash_backward_reference(q, k, v, seg, l, m, do, di, scale)):
                got[f"FB {name}"], want[f"FB {name}"] = x, y
        torch.cuda.synchronize()
        bf16 = dtype == torch.bfloat16
        measure, tol = (bf16_units, FLASH_BF16_UNITS) if bf16 else (relative_to_max, FLASH_FP32_TOL)
        errs = {}
        for name, x, ref, check, limit in (
            *((n, got[n], want[n], measure, tol) for n in got),
            ("l", l, rl, relative_to_max, FLASH_STATS_TOL), ("m", m, rm, relative_to_max, FLASH_STATS_TOL),
        ):
            if not bool(torch.isfinite(x.float()).all()):
                raise RuntimeError(f"flash {name} is not finite at {(b, h, t, d, dtype)}")
            errs[name] = check(x, ref)
            if name in owner:
                abs_errs[owner[name]] = max(abs_errs[owner[name]],
                                            float((x.float() - ref.float()).abs().max()))
            if not errs[name] <= limit:
                raise RuntimeError(f"flash {name} off its plain version at {(b, h, t, d, dtype)}: "
                                   f"{errs[name]:.3e} (limit {limit:g})")
        label = f"B {b} H {h} T {t} D {d} {str(dtype).split('.')[-1]}{' padded' if padded else ''}"
        how = "bf16 units of the row scale" if bf16 else "max |kernel - plain| / max |plain|"
        log(f"flash {label}: O, dQ, dK, dV{' (F1-F3), FB dQ, dK, dV' if fused else ''} in {how}, "
            f"l, m relative to max: " + ", ".join(f"{k_} {v_:.3g}" for k_, v_ in errs.items())
            + f" (limits {tol:g}; l, m {FLASH_STATS_TOL:g}); backward route {backward_route(dtype, d)}")
        if (b, h, t, d, dtype) != (16, 12, 512, 64, torch.bfloat16):
            continue

        # The check must catch a skipped tile: the plain version without one
        # block of P, held to the same limit, must fail it for every output,
        # against F1-F3's plain versions and against FB's.
        fault = dropped_block(q, k, v, seg, l, m, do, di, scale, FLASH_FAULT_BLOCK)
        fault_units = {name: bf16_units(fault[name.split()[-1]], want[name]) for name in want}
        sound_worst = max(errs[name] for name in want)
        log(f"flash {label}: planted fault (one 64 x 64 block of P left out, rows 384-447, keys "
            f"192-255) against the plain versions, bf16 units: " + ", ".join(
                f"{k_} {v_:.3g}" for k_, v_ in fault_units.items())
            + f"; the kernels' worst here {sound_worst:.3g}; limit {tol:g}")
        if not min(fault_units.values()) > tol:
            raise RuntimeError(f"the bf16 limit {tol:g} does not catch a skipped tile: {fault_units}")
        del fault

        # Times at the flash path's shape: plain, kernel, kernel, plain; FB
        # against the split route F2 + F3 in turns.
        def f1():
            return flash_forward(q, k, v, seg, scale)

        def f2():
            return flash_backward_dkv(q, k, v, seg, l, m, do, di, scale)

        def f3():
            return flash_backward_dq(q, k, v, seg, l, m, do, di, scale)

        def fb():
            return flash_backward(q, k, v, seg, l, m, do, di, scale)

        def split():
            return f2(), f3()

        def bwd_split():
            d_i = output_dot(o, do)
            flash_backward_dkv(q, k, v, seg, l, m, do, d_i, scale)
            flash_backward_dq(q, k, v, seg, l, m, do, d_i, scale)

        def bwd():  # what FlashAttention.backward runs at this shape
            flash_backward(q, k, v, seg, l, m, do, output_dot(o, do), scale)

        leaves = [x.detach().requires_grad_() for x in (q, k, v)]

        def fwd_bwd():
            out = FlashAttention.apply(*leaves, seg, scale)
            torch.autograd.grad(out, leaves, do)

        keep = (seg[:, :, None] == seg[:, None, :]) & torch.ones(
            t, t, dtype=torch.bool, device="cuda").tril()
        mask4 = keep[:, None]

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask4, scale=scale)

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(*leaves, attn_mask=mask4, scale=scale)
            torch.autograd.grad(out, leaves, do)

        sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask4, scale=scale)

        def sdpa_bwd():  # SDPA's backward alone, on one retained forward
            torch.autograd.grad(sdpa_out, leaves, do, retain_graph=True)

        att = (seg > 0).to(torch.int32)

        def naive_fwd_bwd():
            out = naive_attention(*leaves, att)
            torch.autograd.grad(out, leaves, do)

        plain = {
            "F1": lambda: flash_forward_reference(q, k, v, seg, scale),
            "F2": lambda: flash_backward_dkv_reference(q, k, v, seg, l, m, do, di, scale),
            "F3": lambda: flash_backward_dq_reference(q, k, v, seg, l, m, do, di, scale),
            "FB": lambda: flash_backward_reference(q, k, v, seg, l, m, do, di, scale),
        }
        kernel = {"F1": f1, "F2": f2, "F3": f3, "FB": fb}
        pairs, work = flash_work(seg, h, d, q.element_size())
        timing = {}
        for name in ("F1", "F2", "F3", "FB"):
            p1 = median_ms(plain[name], iters=5, warmup=1)
            s1 = median_ms(split) if name == "FB" else None
            k1 = median_ms(kernel[name])
            k2 = median_ms(kernel[name])
            s2 = median_ms(split) if name == "FB" else None
            p2 = median_ms(plain[name], iters=5, warmup=1)
            bound, bound_by = roofline(*work[name], BF16_FLOPS)
            timing[name] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=bound,
                                bound_by=bound_by, device_ms=device_ms(kernel[name]),
                                runs=(k1, k2, p1, p2))
            if name == "FB":
                timing[name]["split_ms"] = (s1 + s2) / 2
                timing[name]["split_runs"] = (s1, s2)
                timing[name]["split_device_ms"] = device_ms(split)
                timing[name]["kernel_device_ms"] = device_ms(fb, ("flash_bwd_fused_kernel",))
        extra = {
            "F2+F3 with torch di": median_ms(bwd_split),
            "FB with torch di (the Function's backward)": median_ms(bwd),
            "flash fwd+bwd (autograd Function)": median_ms(fwd_bwd),
            "SDPA fwd": median_ms(sdpa),
            "SDPA bwd alone": median_ms(sdpa_bwd),
            "SDPA bwd alone, device": device_ms(sdpa_bwd),
            "SDPA fwd+bwd": median_ms(sdpa_fwd_bwd),
            "naive fwd+bwd": median_ms(naive_fwd_bwd, iters=10),
        }
        del sdpa_out
        extra["host gap: Function fwd+bwd - (F1 + FB with torch di)"] = (
            extra["flash fwd+bwd (autograd Function)"] - timing["F1"]["ms"]
            - extra["FB with torch di (the Function's backward)"])
        nbytes = work["F1"][0] + work["FB"][0]
        flops = work["F1"][1] + work["FB"][1]
        extra["bound fwd+bwd"] = roofline(nbytes, flops, BF16_FLOPS)[0]
        for name, tm in timing.items():
            log(f"flash {name} at {label}: kernel {tm['ms']:.4f} ms ({tm['runs'][0]:.4f}, "
                f"{tm['runs'][1]:.4f}; device {tm['device_ms']:.4f}), plain {tm['plain_ms']:.3f} ms ({tm['runs'][2]:.3f}, "
                f"{tm['runs'][3]:.3f}), bound {tm['bound_ms']:.4f} ms ({tm['bound_by']}: "
                f"{work[name][0] / 1e6:.1f} MB, {work[name][1] / 1e9:.2f} GFLOP over {pairs:,} "
                f"kept pairs) [{card}]")
        fb_t = timing["FB"]
        log(f"flash FB against F2+F3 in turns (plain, F2+F3, FB, FB, F2+F3, plain) at {label}: "
            f"F2+F3 {fb_t['split_runs'][0]:.4f} / {fb_t['split_runs'][1]:.4f} ms, FB "
            f"{fb_t['runs'][0]:.4f} / {fb_t['runs'][1]:.4f} ms (CUDA events around one call; FB "
            f"includes the wrapper's zeroing of the fp32 dQ sum and its cast to bf16); device "
            f"time per call (torch.profiler): F2+F3 {fb_t['split_device_ms']:.4f} ms, FB with "
            f"the zeroing and cast {fb_t['device_ms']:.4f} ms, the FB kernel alone "
            f"{fb_t['kernel_device_ms']:.4f} ms [{card}]")
        log(f"flash at {label}: " + ", ".join(f"{k_} {v_:.4f} ms" for k_, v_ in extra.items())
            + f" (CUDA-event medians; SDPA with the same boolean mask) [{card}]")
        timing["F1"]["library_ms"] = extra["SDPA fwd"]
        timing["FB"]["library_ms"] = extra["SDPA bwd alone"]
        timing["F2"]["library_ms"] = timing["F3"]["library_ms"] = None
        for tm in timing.values():
            tm.pop("runs")
            tm.pop("split_runs", None)
        timing["extra"] = extra
    out = {name: dict(timing[name], max_abs_err=abs_errs[name]) for name in ("F1", "F2", "F3", "FB")}
    out["extra"] = timing["extra"]
    return out


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


def phase_flash_path(card: str, ctx: dict) -> dict:
    """Phase 5's model, weights, data and factor recipe with attention="flash",
    scored with fp8 query blocks and the auto-sized block."""
    from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
    from kronfluence_tpu_torch.factor.eigen import fit_lambda_matrices_with_loader
    from kronfluence_tpu_torch.models.transformer import gpt2_small, init_transformer
    from kronfluence_tpu_torch.ops.attention import naive_attention
    from kronfluence_tpu_torch.ops.kernels.jacobi import jacobi_pivot_rotations
    from kronfluence_tpu_torch.ops.kernels.probe import probe
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk
    from kronfluence_tpu_torch.prepare import prepare_model
    from kronfluence_tpu_torch.score.pairwise import compute_pairwise_scores_with_loaders
    from kronfluence_tpu_torch.utils.constants import (
        ACTIVATION_COVARIANCE_MATRIX_NAME,
        ALL_MODULE_NAME,
        GRADIENT_COVARIANCE_MATRIX_NAME,
    )
    from kronfluence_tpu_torch.utils.dataset import BatchLoader

    device, task, data = ctx["device"], ctx["task"], ctx["data"]
    config = gpt2_small(max_seq_len=SEQ, dtype=torch.bfloat16, attention="flash")
    model = prepare_model(init_transformer(config, seed=0, device=device), task)
    same = all(torch.equal(a, b) for a, b in zip(model.module.state_dict().values(),
                                                 ctx["model"].module.state_dict().values()))
    if not same:
        raise RuntimeError("the flash path's seed-0 weights differ from phase 5's")
    score_args = copy.deepcopy(ctx["score_args"])
    score_args.query_gradient_storage_dtype = "float8_e4m3fn"
    score_args.query_gradient_accumulation_steps = None

    kernels = flash_kernels()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in (*kernels.values(), syrk, probe, jacobi_pivot_rotations):
        fn.launches = 0
    syrk.wgmma_launches = 0
    naive_attention.calls = 0
    cov, eigen, lam, scores, seconds = run_slice(
        model, task, data, ctx["factor_args"], score_args, device,
        (COV_BATCH, LAMBDA_BATCH, QUERY_BATCH, TRAIN_BATCH),
    )
    launches = {name: fn.launches for name, fn in kernels.items()}
    launches.update(syrk=syrk.launches, probe=probe.launches, jacobi=jacobi_pivot_rotations.launches)
    wgmma_launches = syrk.wgmma_launches
    naive_calls = naive_attention.calls
    peak = torch.cuda.max_memory_allocated() / 2**30
    run = compute_pairwise_scores_with_loaders.last_run

    # Model passes, from the loaders: a forward+backward per covariance and
    # lambda batch, per query batch, and per train batch of every query
    # block; a forward alone for each stage's module discovery (covariance,
    # lambda, pairwise) and for the block sizer's probe.
    cov_b, lam_b = -(-COV_N // COV_BATCH), -(-LAMBDA_N // LAMBDA_BATCH)
    query_b, train_b = -(-QUERY_N // QUERY_BATCH), -(-TRAIN_N // TRAIN_BATCH)
    passes = cov_b + lam_b + query_b + run["blocks"] * train_b
    forwards_only = 3 + 1
    layers = config.num_layers
    # bf16 at head_dim 64: the backward takes the fused route, FB, never F2 or F3.
    want = {"F1": layers * (passes + forwards_only), "F2": 0, "F3": 0, "FB": layers * passes}
    log(f"flash path stage seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
        + f"; peak device memory {peak:.2f} GiB; phase 5 (naive, bf16 dense blocks, "
        f"{QUERY_ACC} accumulation steps): " + ", ".join(
            f"{k} {v:.3f}" for k, v in ctx["seconds"].items()) + f"; peak {ctx['peak']:.2f} GiB [{card}]")
    log(f"flash path: query_gradient_accumulation_steps=None resolved to {run['accumulation']} "
        f"({run['blocks']} block(s) of {QUERY_N} queries); block formats {run['formats']}")
    log(f"flash path kernel launches: " + ", ".join(f"{k} {v}" for k, v in launches.items())
        + f"; want F1 {want['F1']} (12 x ({passes} forward+backward passes + {forwards_only} "
        f"forwards)), FB {want['FB']}, F2 = F3 = 0; naive attention calls {naive_calls}; syrk on "
        f"the wgmma kernel {wgmma_launches} (want {36 * cov_b})")
    for name in kernels:
        if launches[name] != want[name]:
            raise RuntimeError(f"{name} launched {launches[name]} times, want {want[name]}")
    if naive_calls:
        raise RuntimeError(f"the flash path ran the naive form {naive_calls} times")
    if not launches["syrk"] == wgmma_launches == 36 * cov_b:
        raise RuntimeError(f"K1 launches off on the flash path: {launches['syrk']}, "
                           f"{wgmma_launches} on the wgmma kernel; want {36 * cov_b}, all wgmma")
    if launches["probe"] < 1 or launches["jacobi"]:
        raise RuntimeError(f"K2/K3 launches off on the flash path: {launches}")
    if run["formats"] != ["QuantizedGradient[torch.float8_e4m3fn]"]:
        raise RuntimeError(f"the query blocks are not fp8: {run['formats']}")
    if run["accumulation"] != query_b:
        raise RuntimeError(f"the sizer resolved {run['accumulation']} steps; 80 GB holds all "
                           f"{query_b} query batches")
    check_artifacts(cov, eigen, lam, scores, COV_N * SEQ, LAMBDA_N, (QUERY_N, TRAIN_N))

    factor_gap = 0.0
    for factor_name in (ACTIVATION_COVARIANCE_MATRIX_NAME, GRADIENT_COVARIANCE_MATRIX_NAME):
        factor_gap = max(factor_gap, _max_rel(cov[factor_name], ctx["cov"][factor_name]))
    s_f = scores[ALL_MODULE_NAME].float().flatten()
    s_n = ctx["scores"][ALL_MODULE_NAME].float().flatten()
    pearson = float(torch.corrcoef(torch.stack([s_f, s_n]))[0, 1])
    log(f"flash path vs phase 5: covariance factors max |flash - naive| / max |naive| "
        f"{factor_gap:.3e} (limit {FLASH_FACTOR_RTOL:g}); scores finite, Pearson r against "
        f"phase 5's bf16 scores {pearson:.6f} (limit {FLASH_PEARSON_MIN})")
    if not factor_gap <= FLASH_FACTOR_RTOL:
        raise RuntimeError(f"flash path covariance factors off phase 5's: {factor_gap:.3e}")
    if not pearson >= FLASH_PEARSON_MIN:
        raise RuntimeError(f"flash path scores correlate with phase 5's at r {pearson:.4f}")

    # The covariance and lambda stages in turns on the same data and
    # eigenbasis: the naive model, the flash model with its backward on the
    # split route (F2 + F3), and on the fused route (FB, the rule's choice):
    # naive, split, fused, fused, split, naive. Phase 5 ran first in the
    # process, so its stage seconds above are not a like-for-like comparison.
    # The split turns replace the route rule for their duration only; the
    # launch counts above are of the rule's own route.
    from kronfluence_tpu_torch.ops import attention

    rule = attention.backward_route
    forms = ("naive", "flash split", "flash fused")
    turns = {form: {"covariance": [], "lambda": []} for form in forms}
    try:
        for form in ("naive", "flash split", "flash fused", "flash fused", "flash split", "naive"):
            attention.backward_route = (lambda dtype, d: "split") if form == "flash split" else rule
            m_ = ctx["model"] if form == "naive" else model
            _, sec = _stage(fit_covariance_matrices_with_loader, m_, task,
                            BatchLoader(data["cov"], COV_BATCH, device=device), ctx["factor_args"])
            turns[form]["covariance"].append(sec)
            _, sec = _stage(fit_lambda_matrices_with_loader, m_, task,
                            BatchLoader(data["lambda"], LAMBDA_BATCH, device=device),
                            ctx["factor_args"], eigen)
            turns[form]["lambda"].append(sec)
    finally:
        attention.backward_route = rule
    log("stage seconds in turns (naive, flash split, flash fused, flash fused, flash split, "
        "naive): " + "; ".join(f"{stage} " + ", ".join(
            f"{form} {turns[form][stage][0]:.4f}/{turns[form][stage][1]:.4f}" for form in forms)
            for stage in ("covariance", "lambda")) + f" [{card}]")
    return launches


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
        kernel_table(prof, sec, f"eigendecomposition {solver}", card)
        log(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=15))


def kernel_table(prof, sec: float, what: str, card: str, top: int = 6) -> list:
    """Logs a profiled run's kernel time, busy share and top kernels; returns
    the kernel events."""
    # Kernels only: an operator's self device time repeats its kernels'.
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    log(f"profiled {what}: {sec:.4f} s wall, kernel time {device_us / 1e6:.4f} s, busy share "
        f"{device_us / 1e6 / sec:.3f} [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:10.1f} ms {100 * e.self_device_time_total / device_us:5.1f}% "
            f"x{e.count:<6d} {e.key[:90]}")
    return kernels


# Copies of csrc/syrk.cu for `--profile-k1`: name -> text replacements.
_RING = "constexpr int kStages = 4;"
_BOUNDS = "__launch_bounds__(kWgThreads, 1)"
_DIAG = "const bool diag = ti == tj;\n  const int warp"
K1_VARIANTS = {
    "kStages 3, two CTAs an SM": ((_RING, "constexpr int kStages = 3;"),
                                  (_BOUNDS, "__launch_bounds__(kWgThreads, 2)")),
    "kStages 3, one CTA an SM": ((_RING, "constexpr int kStages = 3;"),),
    "one stripe a tile (timing only)": ((_DIAG, "const bool diag = true;\n  const int warp"),),
}


def build_variant(source: str, index: int, replacements, argtypes: dict) -> ctypes.CDLL:
    """csrc/<source> with `replacements` applied, built alone into
    _build/variants/ and loaded with `argtypes` ({C function: argtypes})."""
    from kronfluence_tpu_torch.ops.kernels import build

    src = (build.CSRC_DIR / source).read_text()
    for old, new in replacements:
        if old not in src:
            raise RuntimeError(f"csrc/{source} no longer holds {old!r}")
        src = src.replace(old, new)
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{Path(source).stem}_variant_{index}.cu"
    cu.write_text(src)
    lib_path = cu.with_suffix(".so")
    done = subprocess.run([build._nvcc(), *build.COMPILE_FLAGS, "-shared", "-o", str(lib_path),
                           str(cu)], capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu.name}:\n{done.stdout[-3000:]}{done.stderr[-3000:]}")
    for line in (done.stdout + done.stderr).splitlines():
        if "Used" in line or "spill" in line:
            log(f"    ptxas ({cu.name}): {line.split(':', 1)[-1].strip()}")
    lib = ctypes.CDLL(str(lib_path))
    for name, types in argtypes.items():
        getattr(lib, name).argtypes = types
        getattr(lib, name).restype = ctypes.c_int
    return lib


def profile_k1(card: str) -> None:
    """Covariance-stage seconds (cold, warm) on phase 5's model and data, a
    torch.profiler table of one warm run with K1's device time and share, and
    the wgmma kernel as built against K1_VARIANTS, in turns."""
    from torch.profiler import ProfilerActivity, profile

    from kronfluence_tpu_torch.factor.covariance import fit_covariance_matrices_with_loader
    from kronfluence_tpu_torch.ops.kernels.build import check_launch
    from kronfluence_tpu_torch.ops.kernels.syrk import syrk, syrk_reference
    from kronfluence_tpu_torch.utils.dataset import BatchLoader

    ctx = setup_main_path()

    def covariance():
        return fit_covariance_matrices_with_loader(
            ctx["model"], ctx["task"], BatchLoader(ctx["data"]["cov"], COV_BATCH, device=ctx["device"]),
            ctx["factor_args"],
        )

    for run in ("cold", "warm", "warm"):
        _, sec = _stage(covariance)
        log(f"covariance {run}: {sec:.4f} s [{card}]")
    torch.cuda.synchronize()
    syrk.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, sec = _stage(covariance)
    kernels = kernel_table(prof, sec, "covariance (4 batches)", card, top=8)
    device_us = sum(e.self_device_time_total for e in kernels)
    k1 = [e for e in kernels if "syrk" in e.key]
    k1_us = sum(e.self_device_time_total for e in k1)
    log(f"K1 in the profiled covariance stage: {k1_us / 1e3:.2f} ms, "
        f"{100 * k1_us / device_us:.1f}% of kernel time, {sum(e.count for e in k1)} kernel "
        f"launches ({syrk.launches} by its counter): " + ", ".join(e.key[:60] for e in k1))

    p, i32 = ctypes.c_void_p, ctypes.c_int
    variants = {name: build_variant("syrk.cu", i, repl, {"kf_syrk_bf16_wgmma": [p, p, i32, i32, p]})
                for i, (name, repl) in enumerate(K1_VARIANTS.items())}
    gen = torch.Generator("cuda").manual_seed(0)
    for rows, n in SYRK_MAIN_SHAPES:
        a = torch.randn(rows, n, generator=gen, device="cuda").to(torch.bfloat16)
        want = syrk_reference(a)

        def launch(lib):
            out = torch.empty((n, n), dtype=torch.float32, device="cuda")
            check_launch(lib.kf_syrk_bf16_wgmma(a.data_ptr(), out.data_ptr(), rows, n,
                                                torch.cuda.current_stream().cuda_stream),
                         "syrk variant")
            return out

        times = {"as built (kStages 4, one CTA an SM)": [], **{name: [] for name in variants}}
        for name, lib in variants.items():
            if "timing only" not in name and not syrk_units(launch(lib), want) <= 1.0:
                raise RuntimeError(f"the K1 variant '{name}' disagrees at {rows}x{n}")
        for turn in (0, 1):
            order = list(times) if turn == 0 else list(reversed(times))
            for name in order:
                fn = (lambda: syrk(a)) if name.startswith("as built") else \
                    (lambda lib=variants[name]: launch(lib))
                times[name].append(median_ms(fn))
        lib_ms = median_ms(lambda: torch.mm(a.T, a, out_dtype=torch.float32))
        log(f"K1 {rows}x{n} bf16 in turns (there and back): " + "; ".join(
            f"{name} {t[0]:.4f} / {t[1]:.4f} ms" for name, t in times.items())
            + f"; torch.mm(..., out_dtype=fp32) {lib_ms:.4f} ms [{card}]")


# Copies of csrc/flash_backward.cu for `--profile-flash`: name -> text replacements.
_FB_ATOMICS = """      atomicAdd(reinterpret_cast<float2*>(dq_rows + n * 8), make_float2(dq_acc[n][0], dq_acc[n][1]));
      atomicAdd(reinterpret_cast<float2*>(dq_rows + 8 * kD + n * 8),
                make_float2(dq_acc[n][2], dq_acc[n][3]));"""
FB_VARIANTS = {
    "128-key tile (8 warps, no register cap)": (
        ("constexpr int kKeyTile = 64;", "constexpr int kKeyTile = 128;"),
        ("__global__ void __launch_bounds__(kThreads, 3)", "__global__ void __launch_bounds__(kThreads)")),
    # dQ is computed but never added (one store no input reaches): what the
    # atomics cost.
    "no dQ atomics (timing only)": ((_FB_ATOMICS, """      if (dq_acc[n][0] + dq_acc[n][1] + dq_acc[n][2] + dq_acc[n][3] == 1.0e38f) dq_rows[n * 8] = 0.f;"""),),
}


def profile_flash(card: str) -> None:
    """FB as built (64-key tile) against FB_VARIANTS and F2+F3 at the flash
    path's shape, in turns, after holding each variant to the bf16 limit."""
    from kronfluence_tpu_torch.ops.attention import output_dot
    from kronfluence_tpu_torch.ops.kernels.build import check_launch
    from kronfluence_tpu_torch.ops.kernels.flash import (
        flash_backward,
        flash_backward_dkv,
        flash_backward_dq,
        flash_backward_reference,
        flash_forward,
    )

    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    variants = {name: build_variant("flash_backward.cu", i, repl,
                                    {"kf_flash_bwd_fused": [*[p] * 11, i32, i32, i32, i32, f32, p]})
                for i, (name, repl) in enumerate(FB_VARIANTS.items())}
    b, h, t, d = FLASH_CASES[0][:4]
    gen = torch.Generator("cuda").manual_seed(b * t + d)
    q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    seg = padded_segments(b, t, True, "cuda")
    scale = d ** -0.5
    o, l, m = flash_forward(q, k, v, seg, scale)
    di = output_dot(o, do)
    want = flash_backward_reference(q, k, v, seg, l, m, do, di, scale)

    def launch(lib):
        dq = torch.zeros((b, h, t, d), dtype=torch.float32, device="cuda")
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        check_launch(lib.kf_flash_bwd_fused(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), l.data_ptr(), m.data_ptr(),
            do.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, t, d,
            float(scale), torch.cuda.current_stream().cuda_stream), "FB variant")
        return dq.to(torch.bfloat16), dk, dv

    for name, lib in variants.items():
        if "timing only" in name:
            continue
        units = [bf16_units(x, y) for x, y in zip(launch(lib), want)]
        log(f"FB variant '{name}': dQ, dK, dV in bf16 units {[round(u, 3) for u in units]}")
        if not max(units) <= FLASH_BF16_UNITS:
            raise RuntimeError(f"the FB variant '{name}' disagrees with the plain version")
    fb_kernel, split_kernels = ("flash_bwd_fused_kernel",), ("flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")
    fns = {"as built (64-key tile, 4 warps, 3 CTAs an SM)": (lambda: flash_backward(q, k, v, seg, l, m, do, di, scale),
                                               fb_kernel),
           **{name: (lambda lib=lib: launch(lib), fb_kernel) for name, lib in variants.items()},
           "F2+F3": (lambda: (flash_backward_dkv(q, k, v, seg, l, m, do, di, scale),
                              flash_backward_dq(q, k, v, seg, l, m, do, di, scale)), split_kernels)}
    # What the wrapper adds around the kernel: zeroing the fp32 dQ sum and
    # casting it to bf16.
    dq_sum = torch.zeros((b, h, t, d), dtype=torch.float32, device="cuda")
    fns["wrapper's dQ zeroing + cast alone"] = (
        lambda: (dq_sum.zero_(), dq_sum.to(torch.bfloat16)), ("fill", "elementwise", "copy"))
    times = {name: [] for name in fns}
    for order in (list(fns), list(reversed(fns))):
        for name in order:
            fn, kernels = fns[name]
            times[name].append((median_ms(fn), device_ms(fn, kernels)))
    log(f"FB at B {b} H {h} T {t} D {d} bf16 padded, in turns (there and back); ms per call: "
        f"one call between CUDA events (median), and the device time of the kernels named "
        f"(torch.profiler): " + "; ".join(
            f"{name} " + " / ".join(f"({a:.4f}, {c:.4f})" for a, c in ts)
            for name, ts in times.items()) + f" [{card}]")


def _max_rel(got: dict, want: dict) -> float:
    """max over modules of max|got - want| / max|want| (per-module scale)."""
    worst = 0.0
    for name, w in want.items():
        w = w.double().cpu()
        g = got[name].double().cpu()
        worst = max(worst, float((g - w).abs().max() / w.abs().max().clamp_min(1e-300)))
    return worst


def phase_reference(attention: str = "naive", seq: int = 64, padded: bool = False) -> dict:
    """A small fp32 GPT-2 through the four stages on the card and on the CPU;
    returns the card side's flash launches (every count zeroed just before
    the card side runs). fp32 takes the split backward, F2 + F3."""
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
    # grams pass the K1 shape rule, so the card runs the fp32 kernel. 8 heads
    # of 64: a head_dim the flash kernels take.
    config = tiny_config(
        vocab_size=512, max_seq_len=seq, num_layers=2, num_heads=8, d_model=512,
        dtype=torch.float32, attention=attention,
    )
    task = wikitext_style_task(config.num_layers)
    factor_args = FactorArguments(
        strategy="ekfac", use_empirical_fisher=True, eigendecomposition_dtype="float32"
    )
    score_args = ScoreArguments(damping_factor=None, query_gradient_accumulation_steps=2)
    module = init_transformer(config, seed=0, device="cpu")
    host = {
        k: make_tokens(n, config.max_seq_len, config.vocab_size, seed, "cpu", padded)
        for k, n, seed in (("cov", 32, 11), ("lambda", 32, 13), ("query", 8, 15), ("train", 24, 16))
    }
    flash = flash_kernels()
    out = {}
    eig_cpu = None
    for device in (torch.device("cpu"), torch.device("cuda", 0)):
        model = prepare_model(module.to(device), task)
        data = {k: {c: v.to(device) for c, v in cols.items()} for k, cols in host.items()}
        before = syrk.launches
        for fn in flash.values():
            fn.launches = 0
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
        flash_launches = {name: fn.launches for name, fn in flash.items()}
        out[device.type] = (cov, eig, lam, scores, syrk.launches - before, flash_launches)
    cov_c, eig_c, lam_c, sc_c, _, cpu_flash = out["cpu"]
    cov_g, eig_g, lam_g, sc_g, k1_launches, card_flash = out["cuda"]
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
        f"reference ({attention} attention, T {seq}{', padded' if padded else ''}): small fp32 "
        "GPT-2, card vs CPU, max |diff| / max |ref|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
        + f" (limit {REFERENCE_RTOL:g}); K1 launches on the card side {k1_launches}; "
        f"flash launches on the card side {card_flash}, on the CPU side {cpu_flash}; "
        f"scores {tuple(sc_g[ALL_MODULE_NAME].shape)}"
    )
    if k1_launches == 0:
        raise RuntimeError("the reference run did not reach K1 on the card")
    split = {"F1", "F2", "F3"} if attention == "flash" else set()
    if any(cpu_flash.values()) or {name for name, n in card_flash.items() if n} != split:
        raise RuntimeError(f"flash launches off: card {card_flash} (want F1, F2, F3 with flash, "
                           f"FB never: fp32 takes the split route), CPU {cpu_flash}")
    bad = {k: v for k, v in diffs.items() if not v <= REFERENCE_RTOL}
    if bad:
        raise RuntimeError(f"card disagrees with the CPU reference: {bad}")
    return card_flash


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
    if sys.argv[1:] == ["--profile-k1"]:
        profile_k1(card)
        return
    if sys.argv[1:] == ["--profile-flash"]:
        profile_flash(card)
        return
    if sys.argv[1:]:
        raise SystemExit(f"usage: python3 chip_smoke.py [--profile-eigh | --profile-k1 | "
                         f"--profile-flash]; got {sys.argv[1:]}")
    probe_result = phase_probe()
    syrk_result = phase_syrk(card)
    jacobi_result = phase_jacobi_kernel(card)
    flash_result = phase_flash_kernels(card)
    ctx = phase_main_path(card)
    launches = dict(ctx["launches"], jacobi=phase_jacobi_path(card, ctx))
    # Each flash kernel's launches are those of its own path: F1 and FB from
    # phase 10 (bf16, head_dim 64: the fused route), F2 and F3 from phase 11
    # (fp32: the split route).
    flash_path = phase_flash_path(card, ctx)
    launches.update(F1=flash_path["F1"], FB=flash_path["FB"])
    del ctx
    phase_reference()
    split_path = phase_reference(attention="flash", seq=128, padded=True)
    launches.update(F2=split_path["F2"], F3=split_path["F3"])
    flash_result["F1"]["timings_ms"] = flash_result.pop("extra")
    # The repo's function that reaches the TPU kernels, each Pallas kernel in
    # JAX's own package (jax/experimental/pallas/ops/tpu/flash_attention.py),
    # the CUDA source, and the phase whose run the launches are read from.
    replaced = {
        "F1": ("flash_forward", ["flash_attention.py:589"], "flash_attention.cu",
               "phase 10 (flash path, bf16)"),
        "F2": ("flash_backward_dkv", ["flash_attention.py:941"], "flash_attention.cu",
               "phase 11 (flash reference, fp32: split route)"),
        "F3": ("flash_backward_dq", ["flash_attention.py:1287"], "flash_attention.cu",
               "phase 11 (flash reference, fp32: split route)"),
        "FB": ("flash_backward", ["flash_attention.py:941", "flash_attention.py:1287"],
               "flash_backward.cu", "phase 10 (flash path, bf16: fused route)"),
    }
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
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": f"kronfluence_tpu_torch/csrc/{source}",
            "replaces": "kronfluence_tpu/ops/attention.py:227",
            "pallas_kernel": [f"jax/experimental/pallas/ops/tpu/{w}" for w in where],
            "launches": launches[fid],
            "launches_from": path,
            **flash_result[fid],
        }
        for fid, (name, where, source, path) in replaced.items()
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
