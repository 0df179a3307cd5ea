"""Tracing helpers (counterpart of pg_asr_tpu/utils/profiling.py): a
torch.profiler trace of chosen steps, written as a Chrome trace (open it in
Perfetto or chrome://tracing), and the CUDA caching allocator's memory
statistics.

    prof = start_trace(device)
    ...                                  # the steps to trace
    path = stop_trace(prof, "<model_path>/trace", "steps_3-5")
"""

from __future__ import annotations

import os

import torch
from torch.profiler import ProfilerActivity, profile


def start_trace(device: torch.device | str) -> profile:
    """Start recording host ops and, on a CUDA device, its kernels."""
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof: profile, logdir: str, name: str) -> str:
    """Stop `prof` and write its trace to <logdir>/<name>.pt.trace.json."""
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{name}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


def memory_stats() -> dict:
    """Live and peak bytes of the CUDA caching allocator, per device
    (empty without CUDA)."""
    out = {}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            s = torch.cuda.memory_stats(i)
            out[f"cuda:{i}"] = {
                "bytes_in_use": s.get("allocated_bytes.all.current", 0),
                "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0)}
    return out
