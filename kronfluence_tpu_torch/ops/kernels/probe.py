"""K3: the build-and-launch check (`dst = src + 1` on an (8, 128) fp32 tensor).

Port of `kronfluence_tpu/utils/platform.py:pallas_works`. It never selects a
plain path: it returns when the CUDA library built from `csrc/probe.cu`
launches on the card and computes the right answer, and raises otherwise.
"""

import ctypes

import torch

from kronfluence_tpu_torch.ops.kernels.build import check_launch, load_library

PROBE_SHAPE = (8, 128)


def probe_reference(src: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the probe kernel."""
    return src + 1.0


def launch_probe(lib: ctypes.CDLL, src: torch.Tensor, dst: torch.Tensor) -> None:
    """Launches the probe kernel from `lib` on the current stream of `src`'s
    device: `dst = src + 1`, without a synchronize."""
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = lib.kf_probe_add_one(src.data_ptr(), dst.data_ptr(), src.numel(), stream)
    check_launch(err, "probe")
    probe.launches += 1


def run_probe(lib: ctypes.CDLL, device: torch.device) -> torch.Tensor:
    """Launches the probe kernel from `lib` on `device`, checks and returns
    its output."""
    with torch.cuda.device(device):
        src = torch.zeros(PROBE_SHAPE, dtype=torch.float32, device=device)
        dst = torch.empty_like(src)
        launch_probe(lib, src, dst)
        torch.cuda.synchronize(device)
    if not bool(torch.all(dst == 1.0)):
        raise RuntimeError(
            f"probe kernel on {device} returned wrong values: the CUDA build is broken."
        )
    return dst


def probe(device=None) -> torch.Tensor:
    """Runs K3 on a CUDA device (the plain version on the CPU) and returns its
    output; raises unless every element is exactly 1.0."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cpu":
        return probe_reference(torch.zeros(PROBE_SHAPE, dtype=torch.float32))
    if device.type != "cuda":
        raise ValueError(f"probe() takes a CPU or CUDA device; got {device}.")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with torch.cuda.device(device):
        lib = load_library()
    return run_probe(lib, device)


probe.launches = 0
