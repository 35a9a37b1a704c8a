"""Timing & bandwidth instrumentation — ScopedTimer / ScopedTimerGPU analog.

The reference wraps every phase in RAII timers that print elapsed ms and a
modeled effective bandwidth ``voxels * bytes_per_voxel / time``
(`/root/reference/src/Utils/ScopedTimer.hpp:11-24`,
`/root/reference/src/Cuda/Utils.cuh:246-277`). Here the same accounting is a
context manager around ``block_until_ready`` boundaries, plus the
voxel-updates/sec north-star metric. The per-kernel bytes/voxel constants
below are the reference's own models (HNanoSolver.cu call sites), kept for
apples-to-apples bandwidth reporting.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import jax

# bytes/voxel models from the reference's ScopedTimerGPU call sites
# (`/root/reference/src/Cuda/HNanoSolver.cu:163,173,182,212,227,258,279,343`).
REFERENCE_BYTES_PER_VOXEL = {
    "advect_velocity": 132,
    "vorticity": 516,
    "divergence": 88,
    "combustion": 36,
    "buoyancy": 28,
    "pressure_per_iter": 48,
    "projection": 48,
    "advect_scalars": 76,
}


def full_step_bytes_per_voxel(iterations: int, num_scalars: int = 5) -> int:
    """Modeled HBM traffic per active voxel for one full step, using the
    reference's accounting (pressure counted per iteration)."""
    b = REFERENCE_BYTES_PER_VOXEL
    return (
        b["advect_velocity"]
        + b["vorticity"]
        + b["divergence"]
        + b["combustion"]
        + b["buoyancy"]
        + b["pressure_per_iter"] * iterations
        + b["projection"]
        + b["advect_scalars"]
    )


@dataclass
class TimerRecord:
    name: str
    elapsed_s: float
    voxels: int = 0
    bytes_per_voxel: int = 0

    @property
    def voxel_updates_per_s(self) -> float:
        return self.voxels / self.elapsed_s if self.elapsed_s > 0 else 0.0

    @property
    def modeled_gb_per_s(self) -> float:
        return (
            self.voxels * self.bytes_per_voxel / 1e9 / self.elapsed_s
            if self.elapsed_s > 0
            else 0.0
        )

    def __str__(self):
        s = f"{self.name} Time: {self.elapsed_s * 1e3:.3f} ms"
        if self.voxels:
            s += f" | {self.voxel_updates_per_s / 1e6:.1f} Mvox/s"
        if self.bytes_per_voxel:
            s += f" | {self.modeled_gb_per_s:.1f} GB/s (modeled)"
        return s


@dataclass
class Profiler:
    """Collects TimerRecords; ``scope`` blocks until the given arrays are
    ready, so timings measure real device work (the analog of the
    reference's cudaEvent timers that sync in their destructor)."""

    records: List[TimerRecord] = field(default_factory=list)
    verbose: bool = False

    @contextlib.contextmanager
    def scope(self, name: str, voxels: int = 0, bytes_per_voxel: int = 0):
        out: Dict[str, object] = {}
        t0 = time.perf_counter()
        yield out
        if "result" in out:
            jax.block_until_ready(out["result"])
        rec = TimerRecord(name, time.perf_counter() - t0, voxels, bytes_per_voxel)
        self.records.append(rec)
        if self.verbose:
            print(rec)

    def total(self, name: Optional[str] = None) -> float:
        return sum(r.elapsed_s for r in self.records if name is None or r.name == name)


def time_fn(fn, *args, warmup: int = 2, iters: int = 10, **kw) -> float:
    """Median wall time of ``fn`` with block_until_ready, after warmup."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kw))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kw))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
