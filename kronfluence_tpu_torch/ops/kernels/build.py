"""Builds the hand-written CUDA kernels and loads them with ctypes.

The sources in `kronfluence_tpu_torch/csrc/` are compiled by `nvcc` for
`sm_90a` into one shared library with a plain C interface, at first use, into
`kronfluence_tpu_torch/_build/` (git-ignored). The file name carries a digest
of the sources and flags, so an edited source is rebuilt and a built one is
reused. Nothing here runs at import time: the CPU tests import every module.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("flash_attention.cu", "jacobi.cu", "probe.cu", "syrk.cu")
COMPILE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")


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


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for name in SOURCES:
        digest.update(name.encode())
        digest.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libkf_kernels_{digest.hexdigest()[:16]}.so"


def build_log_path() -> Path:
    return library_path().with_suffix(".log")


def build_library() -> Path:
    """Compiles csrc/ into the shared library unless it is already built: one
    `nvcc -c` per source, all started together, then one link."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    objects = [tmp.with_name(f"{tmp.name}.{Path(s).stem}.o") for s in SOURCES]
    procs = [
        subprocess.Popen(
            [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(CSRC_DIR / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(SOURCES, objects)
    ]
    logs, failed = [], []
    for src, proc in zip(SOURCES, procs):
        out = proc.communicate()[0]
        logs.append(f"== {src}\n{out}")
        if proc.returncode != 0:
            failed.append((src, proc.returncode))
    if not failed:
        link = subprocess.run(
            [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objects)],
            capture_output=True, text=True, check=False,
        )
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(("link", link.returncode))
    for obj in objects:
        obj.unlink(missing_ok=True)
    text = "".join(logs)
    build_log_path().write_text(text)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed}):\n{text[-6000:]}")
    os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Builds (if needed) and loads the kernel library, then runs the K3
    launch check once on the current CUDA device."""
    lib = ctypes.CDLL(str(build_library()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.kf_probe_add_one.argtypes = [ptr, ptr, i32, ptr]
    lib.kf_probe_add_one.restype = i32
    for name in ("kf_syrk_bf16", "kf_syrk_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, i32, i32, i32, ptr]
        fn.restype = i32
    lib.kf_jacobi_pivot_rotations.argtypes = [ptr, ptr, i32, i32, i32, ctypes.c_float, ptr]
    lib.kf_jacobi_pivot_rotations.restype = i32
    f32 = ctypes.c_float
    lib.kf_flash_fwd.argtypes = [i32, *[ptr] * 7, i32, i32, i32, i32, f32, ptr]
    lib.kf_flash_bwd_dkv.argtypes = [i32, *[ptr] * 10, i32, i32, i32, i32, f32, ptr]
    lib.kf_flash_bwd_dq.argtypes = [i32, *[ptr] * 9, i32, i32, i32, i32, f32, ptr]
    for name in ("kf_flash_fwd", "kf_flash_bwd_dkv", "kf_flash_bwd_dq"):
        getattr(lib, name).restype = i32

    import torch

    from kronfluence_tpu_torch.ops.kernels.probe import run_probe

    run_probe(lib, torch.device("cuda", torch.cuda.current_device()))
    return lib


def check_launch(err: int, kernel: str) -> None:
    """Raises if a C launcher reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {err}.")
