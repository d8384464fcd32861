"""Logging and profiling. Port of `kronfluence_tpu/utils/logger.py`.

The Profiler prints the reference's percentage-table summary. Its regions
are timed with `get_time`, which synchronizes the CUDA device first, so a
region's seconds include the device work it queued. `TraceProfiler` also
records a `torch.profiler` trace of the outermost region and writes it as a
Chrome trace. Across processes (`parallel/`), `MultiProcessAdapter` lets rank
0 alone log by default, and `get_time` returns the latest clock of all ranks,
so every rank's regions read the same elapsed times.
"""

import logging
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from kronfluence_tpu_torch.parallel import distributed


class MultiProcessAdapter(logging.LoggerAdapter):
    """Rank-gated logging: by default only process 0 emits; with
    `main_process_only=False` (on the adapter or on one call) every process
    does, each line prefixed with its process index."""

    def __init__(self, logger: logging.Logger, main_process_only: bool = True) -> None:
        super().__init__(logger, {})
        self.main_process_only = main_process_only

    def log(self, level, msg, *args, main_process_only: Optional[bool] = None, **kwargs):
        gate = self.main_process_only if main_process_only is None else main_process_only
        index = distributed.process_index()
        if index != 0:
            if gate:
                return
            msg = f"[process {index}] {msg}"
        super().log(level, msg, *args, **kwargs)


def get_logger(
    name: str, level: Optional[int] = None, main_process_only: bool = True
) -> MultiProcessAdapter:
    logger = logging.getLogger(name)
    if level is not None:
        logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s [%(levelname)s] %(name)s: %(message)s")
        )
        logger.addHandler(handler)
    return MultiProcessAdapter(logger, main_process_only=main_process_only)


def get_time(synchronize: bool = True) -> float:
    """Wall clock after the CUDA device's queued work has finished; across
    processes, the latest of every rank's clock (an all-reduce MAX, so every
    rank must call it at the same point). `synchronize=False` reads this
    process's clock alone: a background thread must not join a collective."""
    if not synchronize:
        return time.perf_counter()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    now = time.perf_counter()
    if distributed.num_processes() > 1:
        on_card = dist.get_backend() == "nccl"
        held = torch.tensor(
            [now], dtype=torch.float64,
            device=torch.device("cuda", torch.cuda.current_device()) if on_card else "cpu",
        )
        dist.all_reduce(held, op=dist.ReduceOp.MAX)
        now = float(held.item())
    return now


class PassThroughProfiler:
    """No-op profiler (the default)."""

    @contextmanager
    def profile(self, action_name: str):
        yield

    def record(self, action_name: str, seconds: float) -> None:
        """Adds a duration measured elsewhere (a background write)."""

    def summary(self) -> str:
        return ""


class Profiler(PassThroughProfiler):
    """Named action timers with a percentage-table summary."""

    def __init__(self) -> None:
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._order: List[str] = []
        self._depths: Dict[str, int] = {}
        self._depth = 0

    def _register(self, action_name: str) -> None:
        if action_name not in self._totals:
            self._order.append(action_name)
            # Stage functions nest regions; the summary's total sums only the
            # top-level ones.
            self._depths[action_name] = self._depth

    @contextmanager
    def profile(self, action_name: str):
        self._register(action_name)
        self._depth += 1
        start = get_time()
        try:
            yield
        finally:
            self._depth -= 1
            self._totals[action_name] += get_time() - start
            self._counts[action_name] += 1

    def record(self, action_name: str, seconds: float) -> None:
        self._register(action_name)
        self._totals[action_name] += seconds
        self._counts[action_name] += 1

    def rows(self) -> List[Tuple[str, float, int]]:
        return [(name, self._totals[name], self._counts[name]) for name in self._order]

    def summary(self) -> str:
        total = sum(t for name, t in self._totals.items() if self._depths.get(name, 0) == 0)
        if total <= 0:
            return "Profiler Report: no recorded actions."
        rule = "-" * 100
        lines = [
            rule,
            f"{'Action':<50}|  {'Mean duration (s)':<18}|  {'Num calls':<10}|  "
            f"{'Total time (s)':<15}|  {'Percentage %':<13}",
            rule,
            f"{'Total':<50}|  {'-':<18}|  {'1':<10}|  {total:<15.5}|  {100.0:<13.5}",
            rule,
        ]
        for name, t, c in sorted(self.rows(), key=lambda r: -r[1]):
            display = ("  " * self._depths.get(name, 0)) + name
            lines.append(
                f"{display:<50}|  {t / max(c, 1):<18.5}|  {c:<10}|  {t:<15.5}|  "
                f"{100.0 * t / total:<13.5}"
            )
        return "\n".join(lines)


class TraceProfiler(Profiler):
    """Profiler that also traces the outermost region with `torch.profiler`
    (CPU, and CUDA when a card is present) and writes a Chrome trace per
    outermost region into `trace_dir`; nested regions appear as labelled
    spans (`record_function`) inside it."""

    def __init__(self, trace_dir: str = "./profiler_output") -> None:
        super().__init__()
        self.trace_dir = Path(trace_dir)
        self._trace = None

    @contextmanager
    def profile(self, action_name: str):
        outer = self._trace is None
        if outer:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._trace = torch.profiler.profile(activities=activities)
            self._trace.__enter__()
        try:
            with torch.profiler.record_function(action_name), super().profile(action_name):
                yield
        finally:
            if outer:
                trace, self._trace = self._trace, None
                trace.__exit__(None, None, None)
                self.trace_dir.mkdir(parents=True, exist_ok=True)
                slug = action_name.lower().replace(" ", "_")
                trace.export_chrome_trace(
                    str(self.trace_dir / f"{slug}_{time.time_ns()}.json")
                )
