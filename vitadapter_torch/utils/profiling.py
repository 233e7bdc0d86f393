"""Profiling utilities (counterpart of `vitadapter/utils/profiling.py`): a
`torch.profiler` trace, the CUDA allocator's memory statistics, and a step
timer on the device's clock (the reference's IterTimerHook and CUDA
max-memory logging, `detection/mmcv_custom/customized_text.py:50-61,113-116`).
"""

import contextlib
import os
import time
from typing import Dict

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the host and, where there is one, the CUDA device with
    `torch.profiler`; writes a Chrome trace (`trace.json`) into `logdir`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Bytes the CUDA allocator holds for tensors, now and at its peak, per
    device; empty without CUDA."""
    out = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available()
                   else 0):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", -1),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", -1)}
    return out


class StepTimer:
    """Step timing with a data-time split (reference
    CustomizedTextLoggerHook fields: time / data_time / ETA). On a CUDA
    device the span is read from CUDA events recorded on its stream, so it
    ends when the device has finished the last step, not when the host
    queued it; on the CPU, where each step runs to its end before the call
    returns, from the host clock."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.reset()

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def reset(self):
        self._start = self._mark()
        self.data_time = 0.0
        self.steps = 0

    def data_tick(self, seconds: float):
        self.data_time += seconds

    def step(self):
        self.steps += 1

    def elapsed(self) -> float:
        """Seconds since `reset` (waits for the device)."""
        end = self._mark()
        if not self.cuda:
            return end - self._start
        end.synchronize()
        return self._start.elapsed_time(end) / 1e3

    def summary(self, total_steps_left: int) -> Dict[str, float]:
        per = self.elapsed() / max(self.steps, 1)
        return {"time": per,
                "data_time": self.data_time / max(self.steps, 1),
                "eta_hours": per * total_steps_left / 3600.0}
