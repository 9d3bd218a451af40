"""What the kinds of traffic share: a run's context and outcome, the
device's clock and memory, and the check's numbers beside their limits."""

from __future__ import annotations

import json
import os
import subprocess
from dataclasses import dataclass, field

import torch

__all__ = ["Run", "Outcome", "Check", "synchronize", "peak_memory", "power_limit_w", "load_json",
           "ROOT"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(rel_path: str):
    with open(os.path.join(ROOT, rel_path)) as f:
        return json.load(f)


@dataclass
class Run:
    """One run of one cell."""

    cell: dict  # the workload's entry of BENCHMARK.json
    config: dict  # its configuration file
    traffic: dict  # its traffic file
    limits: dict  # its limits file: {number: limit}
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # perf_counter() at process start
    control: str | None = None  # mc: the program's bfloat16 carry ("bf16"), for calibration and tests only
    batch: int | None = None  # a smaller batch than the mix's, for the CPU tests only


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self):
        return self.value <= self.limit


@dataclass
class Outcome:
    metrics: dict  # end-to-end values by name
    attempted: int
    failed: int
    checks: list  # [Check]
    memory_peak_bytes: int
    trace: object = None  # trace.TraceData of the traced run, or None
    context: dict = field(default_factory=dict)  # what the per-layer readers need
    notes: list = field(default_factory=list)  # printed on standard error

    @property
    def correct(self):
        return bool(self.checks) and all(c.ok for c in self.checks)


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_memory(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def power_limit_w():
    """The card's power limit in W from nvidia-smi, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
