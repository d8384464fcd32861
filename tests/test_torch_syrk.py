"""K1 (syrk) and K3 (probe) of kronfluence_tpu_torch against the JAX package.

On the CPU the port's wrappers take their plain versions, so these tests hold
the plain versions against the JAX Pallas kernel (interpret mode) and check
the dispatch rules, the kernels' triangle enumeration and the per-source
build. The CUDA kernels themselves are compared with the plain versions on
the card by chip_smoke.py and by the `cuda`-marked tests below.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kronfluence_tpu.ops.pallas.syrk import syrk as jax_syrk
from kronfluence_tpu.ops.pallas.syrk import syrk_supported as jax_syrk_supported
from kronfluence_tpu_torch.ops.covariance import bordered_gram, gram
from kronfluence_tpu_torch.ops.kernels import build
from kronfluence_tpu_torch.ops.kernels.probe import PROBE_SHAPE, probe, probe_reference
from kronfluence_tpu_torch.ops.kernels.syrk import (
    TILE,
    bf16_route,
    syrk,
    syrk_reference,
    syrk_supported,
    tile_pair,
    triangle_tiles,
)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,n", [(300, 700), (640, 1100), (77, 513), (500, 640)])
def test_syrk_reference_matches_jax_kernel(rows, n, dtype):
    """The plain version against the interpret-mode Pallas kernel on the JAX
    package's own syrk test shapes, fp32 accumulation. fp32 operands: fp32
    summation-order noise (5e-6 of max|C|, the JAX package's bound for this
    kernel). bf16 operands: products of bf16 values are exact in fp32, so
    again only the summation order differs."""
    a = np.random.default_rng(rows + n).standard_normal((rows, n)).astype(np.float32)
    ja = jnp.asarray(a, jnp.dtype(dtype))
    want = np.asarray(jax_syrk(ja, jnp.float32, tile_n=256, tile_k=256, interpret=True))
    ta = torch.tensor(np.asarray(ja.astype(jnp.float32))).to(getattr(torch, dtype))
    got = syrk_reference(ta, torch.float32)
    assert got.dtype == torch.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=5e-6)


@pytest.mark.parametrize(
    "n,accum",
    [
        (2048, "float32"), (3073, "float32"), (769, "float32"), (2048, "float64"),
        (768, "float32"), (2304, "float32"), (3072, "float32"), (1536, "float32"),
        (1537, "float32"), (2304, "bfloat16"),
    ],
)
def test_syrk_supported_agrees_with_jax(n, accum):
    assert syrk_supported(n, accum) == jax_syrk_supported(n, jnp.dtype(accum))


def test_gpt2_widths_route_as_in_jax():
    """The main path's gram widths: 2304 and 3072 go to K1, 768 and 769 do not."""
    assert syrk_supported(2304, torch.float32)
    assert syrk_supported(3072, torch.float32)
    assert not syrk_supported(768, torch.float32)
    assert not syrk_supported(769, torch.float32)


@pytest.mark.parametrize(
    "n,route",
    [
        # GPT-2 small's gram widths (2304 and 3072 reach K1) and their
        # bias-augmented twins.
        (768, "wgmma"), (769, "wmma"), (2304, "wgmma"), (3072, "wgmma"), (3073, "wmma"),
        # Ragged widths: TMA needs a row stride of whole 16-byte units.
        (2000, "wgmma"), (904, "wgmma"), (1001, "wmma"), (1004, "wmma"), (1020, "wmma"),
    ],
)
def test_bf16_route_by_width(n, route):
    """An aligned operand takes the wgmma kernel exactly when n % 8 == 0."""
    a = torch.empty((4, n), dtype=torch.bfloat16)
    assert a.data_ptr() % 16 == 0
    assert bf16_route(n, a.data_ptr()) == route


@pytest.mark.parametrize("offset,route", [(0, "wgmma"), (1, "wmma"), (4, "wmma"), (8, "wgmma")])
def test_bf16_route_of_an_offset_view(offset, route):
    """A contiguous view that starts `offset` bf16 elements into its storage
    is 16-byte aligned only at multiples of 8 elements."""
    rows, n = 16, 3072
    base = torch.empty(rows * n + 8, dtype=torch.bfloat16)
    view = base[offset:offset + rows * n].view(rows, n)
    assert view.is_contiguous() and view.data_ptr() == base.data_ptr() + 2 * offset
    assert bf16_route(n, view.data_ptr()) == route


def test_tile_pair_covers_the_lower_triangle_once():
    """CTA p's tile, as the kernels compute it: for every tile count T up to
    64, the T(T+1)/2 CTAs take each (i, j <= i) exactly once, row by row."""
    for t in range(1, 65):
        got = [tile_pair(p) for p in range(t * (t + 1) // 2)]
        assert got == [(i, j) for i in range(t) for j in range(i + 1)], t


@pytest.mark.parametrize("n,tiles", [(3072, 300), (2304, 171), (2000, 136), (1001, 36), (128, 1)])
def test_triangle_tiles(n, tiles):
    assert triangle_tiles(n) == tiles
    assert triangle_tiles(n) == len({tile_pair(p) for p in range(tiles)})
    assert TILE == 128


def test_cpu_tensor_takes_plain_path_and_counts_nothing():
    before, wgmma_before = syrk.launches, syrk.wgmma_launches
    a = torch.from_numpy(np.random.default_rng(1).standard_normal((64, 2048)).astype(np.float32))
    got = syrk(a, torch.float32)
    via_gram = gram(a, torch.float32)  # 2048 passes the shape rule
    syrk(a.to(torch.bfloat16))
    assert syrk.launches == before
    assert syrk.wgmma_launches == wgmma_before
    want = a.double().T @ a.double()
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=1e-4, atol=1e-3)
    assert torch.equal(via_gram, got)


def test_non_cpu_non_cuda_tensor_raises_instead_of_falling_back():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        syrk(torch.empty((16, 2048), device="meta"), torch.float32)


def test_bordered_gram_equals_gram_of_bias_augmented_operand():
    """The analytic bias border equals gram([A | mask]) (float64, exact)."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((40, 7)))
    mask = torch.from_numpy((rng.random((40, 1)) > 0.3).astype(np.float64))
    a2 = a * mask
    got = bordered_gram(a2, mask.sum().to(torch.int64), True, torch.float64)
    aug = torch.cat([a2, mask], dim=1)
    torch.testing.assert_close(got, aug.T @ aug, rtol=1e-12, atol=1e-12)


def test_probe_plain_version():
    src = torch.zeros(PROBE_SHAPE, dtype=torch.float32)
    assert torch.equal(probe_reference(src), torch.ones(PROBE_SHAPE))
    before = probe.launches
    assert torch.equal(probe("cpu"), torch.ones(PROBE_SHAPE))
    assert probe.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["normal", "abs"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,n", [(8192, 3072), (8192, 2304), (1000, 2000), (300, 1001)])
def test_cuda_syrk_matches_plain_version(rows, n, dtype, kind):
    """Card only: a bf16 operand takes the kernel `bf16_route` names (by the
    wgmma counter: the wgmma kernel at n % 8 == 0, else wmma); C is exactly
    symmetric, and |kernel - plain| <= 1e-4 max|C| + 1e-4 |plain| (fp32 sums
    of exact products in another order), also on a positive-mean input
    (|normal|, as post-GELU activations are), whose off-diagonal entries are
    about as large as its diagonal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain version only")
    gen = torch.Generator("cuda").manual_seed(0)
    a = torch.randn(rows, n, generator=gen, device="cuda")
    a = (a.abs() if kind == "abs" else a).to(dtype)
    wgmma = dtype == torch.bfloat16 and bf16_route(n, a.data_ptr()) == "wgmma"
    assert wgmma == (dtype == torch.bfloat16 and n % 8 == 0)
    before, wgmma_before = syrk.launches, syrk.wgmma_launches
    got = syrk(a)
    want = syrk_reference(a)
    torch.cuda.synchronize()
    assert syrk.launches == before + 1
    assert syrk.wgmma_launches == wgmma_before + wgmma
    assert torch.equal(got, got.T)
    assert bool(((got - want).abs() <= 1e-4 * want.abs().max() + 1e-4 * want.abs()).all())


@pytest.mark.cuda
def test_cuda_probe_runs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain version only")
    before = probe.launches
    assert torch.equal(probe("cuda").cpu(), torch.ones(PROBE_SHAPE))
    assert probe.launches == before + 1


# The per-source build, driven by a stand-in for nvcc that writes its -o file
# and logs what it compiled.
_FAKE_NVCC = """import sys
from pathlib import Path
args = sys.argv[1:]
out = Path(args[args.index("-o") + 1])
with open(Path(__file__).with_name("calls.txt"), "a") as f:
    f.write((args[-1] if "-c" in args else "link") + "\\n")
if "-c" in args and "#error" in Path(args[-1]).read_text():
    print("ptxas fatal: planted error")
    sys.exit(1)
out.write_text("built")
"""


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "common.cuh").write_text("// shared\n")
    (csrc / "a.cu").write_text('#include "common.cuh"\n// a\n')
    (csrc / "b.cu").write_text("#include <cuda_runtime.h>\n// b\n")
    nvcc = tmp_path / "nvcc.py"
    nvcc.write_text(_FAKE_NVCC)
    script = tmp_path / "nvcc"
    script.write_text(f"#!/bin/sh\nexec {sys.executable} {nvcc} \"$@\"\n")
    script.chmod(0o755)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "SOURCES", ("a.cu", "b.cu"))
    monkeypatch.setattr(build, "_nvcc", lambda: str(script))

    def calls():
        path = tmp_path / "calls.txt"
        lines = path.read_text().split() if path.exists() else []
        path.unlink(missing_ok=True)
        return [Path(line).name for line in lines]

    return csrc, calls


def test_object_names_follow_source_headers_and_flags(fake_build, monkeypatch):
    csrc, _ = fake_build
    a, b, lib = build.object_path("a.cu"), build.object_path("b.cu"), build.library_path()
    assert a.name.startswith("a_") and b.name.startswith("b_") and a.suffix == ".o"
    (csrc / "b.cu").write_text("// b, edited\n")
    assert build.object_path("a.cu") == a and build.object_path("b.cu") != b
    assert build.library_path() != lib
    b = build.object_path("b.cu")
    (csrc / "common.cuh").write_text("// shared, edited\n")
    assert build.object_path("a.cu") != a and build.object_path("b.cu") == b
    monkeypatch.setattr(build, "COMPILE_FLAGS", build.COMPILE_FLAGS + ("-DX",))
    assert build.object_path("b.cu") != b


def test_flash_attention_compiles_split_and_the_rest_whole():
    """nvcc optimizes flash_attention.cu's 18 kernels in parallel threads;
    every other source compiles with the common flags."""
    assert build.compile_flags("flash_attention.cu") == build.COMPILE_FLAGS + (
        "--split-compile=0",)
    for source in build.SOURCES:
        if source != "flash_attention.cu":
            assert build.compile_flags(source) == build.COMPILE_FLAGS


def test_build_recompiles_only_the_edited_source(fake_build):
    csrc, calls = fake_build
    first = build.build_library()
    assert first.exists() and sorted(calls()) == ["a.cu", "b.cu", "link"]
    assert build.build_library() == first and calls() == []
    (csrc / "b.cu").write_text("// b, edited\n")
    second = build.build_library()
    assert second != first and calls() == ["b.cu", "link"]
    log = build.build_log_path().read_text()
    assert "== a.cu" in log and "== b.cu" in log and "== link" in log


def test_build_failure_raises_with_the_log_and_keeps_good_objects(fake_build):
    csrc, calls = fake_build
    (csrc / "b.cu").write_text("#error planted\n")
    with pytest.raises(RuntimeError, match="planted error"):
        build.build_library()
    assert sorted(calls()) == ["a.cu", "b.cu"]
    assert build.object_path("a.cu").exists() and not build.object_path("b.cu").exists()
    assert not build.library_path().exists()
    (csrc / "b.cu").write_text("// b, fixed\n")
    build.build_library()
    assert calls() == ["b.cu", "link"]
