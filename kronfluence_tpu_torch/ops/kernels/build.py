"""Builds the hand-written CUDA kernels and loads them with ctypes.

Each source in `kronfluence_tpu_torch/csrc/` is compiled by `nvcc` for
`sm_90a` into its own object in `kronfluence_tpu_torch/_build/` (git-ignored),
named by a digest of the source, the `csrc/` headers it includes and the
compile flags. The objects are linked into one shared library with a plain C
interface, named by a digest of its objects and the link flags. So an edit of
one source recompiles that source alone and relinks; the other objects are
reused. Everything is built at first use: nothing here runs at import time,
and the CPU tests import every module.
"""

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = (
    "flash_attention.cu", "flash_backward.cu", "flash_backward_d128.cu", "flash_backward_d256.cu",
    "flash_backward_f32.cu", "flash_backward_f32_d128.cu", "flash_backward_f32_d256.cu",
    "flash_forward.cu", "flash_forward_d256.cu", "flash_forward_f32.cu", "flash_forward_f32_d64.cu",
    "jacobi.cu",
    "jacobi_m64.cu", "probe.cu", "syrk.cu",
)
COMPILE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# Sources whose device code nvcc optimizes in parallel threads: flash_attention.cu
# (18 kernels) was the build's longest compile, about 250 s alone against 76 s
# split on an 8-core host, with the same registers a kernel.
SPLIT_COMPILE_SOURCES = ("flash_attention.cu",)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "kronfluence_tpu_torch are built from source at first use."
    )


def _local_headers(source: Path) -> list:
    """The `csrc/` files that `source` includes with quotes, transitively."""
    found, todo = [], [source]
    while todo:
        for name in _LOCAL_INCLUDE.findall(todo.pop().read_bytes()):
            header = CSRC_DIR / name.decode()
            if header.exists() and header not in found:
                found.append(header)
                todo.append(header)
    return sorted(found)


def compile_flags(source: str) -> tuple:
    """The nvcc flags that compile `csrc/<source>`."""
    return COMPILE_FLAGS + (("--split-compile=0",) if source in SPLIT_COMPILE_SOURCES else ())


def object_path(source: str) -> Path:
    """Where `csrc/<source>` compiles to: the name carries a digest of the
    source, its local headers and its compile flags."""
    path = CSRC_DIR / source
    digest = hashlib.sha256(" ".join(compile_flags(source)).encode())
    for part in [path, *_local_headers(path)]:
        digest.update(part.name.encode())
        digest.update(part.read_bytes())
    return BUILD_DIR / f"{path.stem}_{digest.hexdigest()[:16]}.o"


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(LINK_FLAGS).encode())
    for source in SOURCES:
        digest.update(object_path(source).name.encode())
    return BUILD_DIR / f"libkf_kernels_{digest.hexdigest()[:16]}.so"


def build_log_path() -> Path:
    return library_path().with_suffix(".log")


def _compile_missing() -> tuple:
    """Compiles every source whose object is not built yet, one `nvcc -c`
    each, all started together. Returns the failures and the sources'
    logs (each object keeps its own log beside it)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for source in SOURCES:
        obj = object_path(source)
        if not obj.exists():
            tmp = obj.with_name(f"{obj.name}.{os.getpid()}.tmp")
            jobs[source] = (obj, tmp, subprocess.Popen(
                [_nvcc(), *compile_flags(source), "-c", "-o", str(tmp), str(CSRC_DIR / source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
    failed = []
    for source, (obj, tmp, proc) in jobs.items():
        obj.with_suffix(".log").write_text(f"== {source}\n{proc.communicate()[0]}")
        if proc.returncode == 0:
            os.replace(tmp, obj)
        else:
            tmp.unlink(missing_ok=True)
            failed.append((source, proc.returncode))
    logs = []
    for source in SOURCES:
        log = object_path(source).with_suffix(".log")
        logs.append(log.read_text() if log.exists() else f"== {source}\n(no log)\n")
    return failed, "".join(logs)


def build_library() -> Path:
    """Compiles the sources whose objects are missing, then links the
    library unless it is already built."""
    path = library_path()
    if path.exists():
        return path
    failed, text = _compile_missing()
    if not failed:
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        objects = [str(object_path(source)) for source in SOURCES]
        link = subprocess.run(
            [_nvcc(), *LINK_FLAGS, "-o", str(tmp), *objects],
            capture_output=True, text=True, check=False,
        )
        text += f"== link\n{link.stdout}{link.stderr}"
        if link.returncode == 0:
            os.replace(tmp, path)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(("link", link.returncode))
    build_log_path().write_text(text)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed}):\n{text[-6000:]}")
    return path


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Builds (if needed) and loads the kernel library, then runs the K3
    launch check once on the current CUDA device."""
    lib = ctypes.CDLL(str(build_library()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.kf_probe_add_one.argtypes = [ptr, ptr, i32, ptr]
    lib.kf_probe_add_one.restype = i32
    lib.kf_syrk_bf16_wgmma.argtypes = [ptr, ptr, i32, i32, ptr]
    lib.kf_syrk_bf16_wgmma.restype = i32
    lib.kf_syrk_bf16_wgmma_smem_bytes.argtypes = []
    lib.kf_syrk_bf16_wgmma_smem_bytes.restype = i32
    lib.kf_syrk_f16_wgmma.argtypes = [ptr, ptr, i32, i32, ptr]
    lib.kf_syrk_f16_wgmma.restype = i32
    lib.kf_syrk_bf16.argtypes = [ptr, ptr, i32, i32, ptr]
    lib.kf_syrk_bf16.restype = i32
    lib.kf_syrk_f16.argtypes = [ptr, ptr, i32, i32, ptr]
    lib.kf_syrk_f16.restype = i32
    lib.kf_syrk_f32.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
    lib.kf_syrk_f32.restype = i32
    lib.kf_syrk_f32_reduce.argtypes = [ptr, ptr, i32, i32, ptr]
    lib.kf_syrk_f32_reduce.restype = i32
    lib.kf_syrk_f32_occupancy.argtypes = [i32, ptr, ptr, ptr]
    lib.kf_syrk_f32_occupancy.restype = i32
    lib.kf_jacobi_pivot_rotations.argtypes = [ptr, ptr, i32, i32, i32, ctypes.c_float, ptr]
    lib.kf_jacobi_pivot_rotations.restype = i32
    lib.kf_jacobi_pivot_rotations_m64.argtypes = [ptr, ptr, i32, i32, ctypes.c_float, ptr]
    lib.kf_jacobi_pivot_rotations_m64.restype = i32
    f32 = ctypes.c_float
    lib.kf_flash_fwd.argtypes = [i32, *[ptr] * 7, i32, i32, i32, i32, f32, ptr]
    lib.kf_flash_bwd_dkv.argtypes = [i32, *[ptr] * 10, i32, i32, i32, i32, f32, ptr]
    lib.kf_flash_bwd_dq.argtypes = [i32, *[ptr] * 9, i32, i32, i32, i32, f32, ptr]
    lib.kf_flash_bwd_fused.argtypes = [*[ptr] * 11, i32, i32, i32, i32, f32, ptr]
    lib.kf_flash_fwd_pipelined.argtypes = [*[ptr] * 7, i32, i32, i32, i32, f32, ptr]
    lib.kf_flash_fwd_d128.argtypes = [*[ptr] * 7, i32, i32, i32, i32, f32, ptr]
    lib.kf_flash_fwd_occupancy.argtypes = [i32, ptr, ptr, ptr]
    lib.kf_flash_fwd_d256.argtypes = [*[ptr] * 7, i32, i32, i32, i32, f32, ptr]
    lib.kf_flash_fwd_d256_occupancy.argtypes = [i32, ptr, ptr, ptr]
    lib.kf_flash_fwd_f32.argtypes = [*[ptr] * 7, i32, i32, i32, i32, f32, ptr]
    lib.kf_flash_fwd_f32_occupancy.argtypes = [i32, ptr, ptr, ptr]
    lib.kf_flash_fwd_f32_d64.argtypes = [*[ptr] * 7, i32, i32, i32, i32, f32, ptr]
    lib.kf_flash_fwd_f32_d64_occupancy.argtypes = [i32, ptr, ptr, ptr]
    lib.kf_flash_bwd_dkv_d128.argtypes = [*[ptr] * 10, i32, i32, i32, i32, f32, ptr]
    lib.kf_flash_bwd_dq_d128.argtypes = [*[ptr] * 9, i32, i32, i32, i32, f32, ptr]
    lib.kf_flash_bwd_d128_occupancy.argtypes = [i32, ptr, ptr, ptr]
    lib.kf_flash_bwd_dkv_d256.argtypes = [*[ptr] * 10, i32, i32, i32, i32, f32, ptr]
    lib.kf_flash_bwd_dq_d256.argtypes = [*[ptr] * 9, i32, i32, i32, i32, f32, ptr]
    lib.kf_flash_bwd_d256_occupancy.argtypes = [i32, ptr, ptr, ptr]
    lib.kf_flash_bwd_dkv_f32.argtypes = [*[ptr] * 10, i32, i32, i32, i32, f32, ptr]
    lib.kf_flash_bwd_dq_f32.argtypes = [*[ptr] * 9, i32, i32, i32, i32, f32, ptr]
    lib.kf_flash_bwd_f32_occupancy.argtypes = [i32, ptr, ptr, ptr]
    lib.kf_flash_bwd_dkv_f32_d128.argtypes = [*[ptr] * 10, i32, i32, i32, i32, f32, ptr]
    lib.kf_flash_bwd_dq_f32_d128.argtypes = [*[ptr] * 9, i32, i32, i32, i32, f32, ptr]
    lib.kf_flash_bwd_f32_d128_occupancy.argtypes = [i32, ptr, ptr, ptr]
    lib.kf_flash_bwd_dkv_f32_d256.argtypes = [*[ptr] * 10, i32, i32, i32, i32, f32, ptr]
    lib.kf_flash_bwd_dq_f32_d256.argtypes = [*[ptr] * 9, i32, i32, i32, i32, f32, ptr]
    lib.kf_flash_bwd_f32_d256_occupancy.argtypes = [i32, ptr, ptr, ptr]
    for name in ("kf_flash_fwd", "kf_flash_bwd_dkv", "kf_flash_bwd_dq", "kf_flash_bwd_fused",
                 "kf_flash_fwd_pipelined", "kf_flash_fwd_d128", "kf_flash_fwd_occupancy",
                 "kf_flash_fwd_d256", "kf_flash_fwd_d256_occupancy",
                 "kf_flash_fwd_f32", "kf_flash_fwd_f32_occupancy",
                 "kf_flash_fwd_f32_d64", "kf_flash_fwd_f32_d64_occupancy",
                 "kf_flash_bwd_dkv_d128", "kf_flash_bwd_dq_d128", "kf_flash_bwd_d128_occupancy",
                 "kf_flash_bwd_dkv_d256", "kf_flash_bwd_dq_d256", "kf_flash_bwd_d256_occupancy",
                 "kf_flash_bwd_dkv_f32", "kf_flash_bwd_dq_f32", "kf_flash_bwd_f32_occupancy",
                 "kf_flash_bwd_dkv_f32_d128", "kf_flash_bwd_dq_f32_d128",
                 "kf_flash_bwd_f32_d128_occupancy", "kf_flash_bwd_dkv_f32_d256",
                 "kf_flash_bwd_dq_f32_d256", "kf_flash_bwd_f32_d256_occupancy"):
        getattr(lib, name).restype = i32

    import torch

    from kronfluence_tpu_torch.ops.kernels.probe import run_probe

    run_probe(lib, torch.device("cuda", torch.cuda.current_device()))
    return lib


def check_launch(err: int, kernel: str) -> None:
    """Raises if a C launcher reported an error: a CUDA error code, or for the
    wgmma syrk and FFW a negative `cuTensorMapEncodeTiled` result."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {err}.")
