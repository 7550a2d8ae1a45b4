"""Per-pass timing harness — the GPUMetric/ImPlot HUD analog.

The reference brackets every task with timestamp queries
(``/root/reference/src/utils/gpu_metric.{hpp,cpp}``: 2048-query pool,
start/end per task, elapsed ms readback) and plots grouped categories
(``renderer.cpp:517-588, 769-806``).  A fused XLA frame has no internal
timestamps, so the equivalent is this harness: run each pass's jitted
sub-function in isolation over representative inputs, amortized with a
device-side repeat loop (amortizing dispatch), and keep
a scrolling history per pass.

Use: tools/profile_passes.py prints the per-pass table; the web viewer
shows whole-frame timings live.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np


class ScrollingBuffer:
    """Fixed-capacity metric history (utils/scrolling_buffer.hpp:4-23)."""

    def __init__(self, capacity: int = 2000):
        self.capacity = capacity
        self.data = deque(maxlen=capacity)

    def add_point(self, t, value):
        self.data.append((t, value))

    def erase(self):
        self.data.clear()

    def as_arrays(self):
        if not self.data:
            return np.zeros(0), np.zeros(0)
        a = np.asarray(self.data)
        return a[:, 0], a[:, 1]


class GPUMetric:
    """One pass timer (gpu_metric.hpp GPUMetric analog)."""

    def __init__(self, name: str):
        self.name = name
        self.time_elapsed = 0.0       # ms, like GPUMetric::time_elapsed
        self.history = ScrollingBuffer()

    def measure(self, fn, *args, iters: int = 8):
        """Time fn(*args) with device sync, amortized over iters."""
        import jax
        jax.block_until_ready(fn(*args))       # compile + warm
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        self.time_elapsed = (time.perf_counter() - t0) * 1e3 / iters
        self.history.add_point(time.time(), self.time_elapsed)
        return self.time_elapsed


class GPUMetricPool:
    """Named metric registry (gpu_metric.hpp GPUMetricPool +
    context.hpp gpu_metrics map analog), with the reference's category
    grouping (renderer.cpp:558-588)."""

    CATEGORIES = {
        "depth prepass": "Geometry", "shadow": "Shadows",
        "g-buffer": "Geometry", "terrain": "Geometry",
        "bloom": "Bloom", "ssao": "SSAO", "ssr": "Reflections",
        "clouds": "Sky", "composition": "Lighting",
        "luminance": "Exposure", "taa": "AntiAliasing",
        "tonemap": "PostProcess",
    }

    def __init__(self):
        self.metrics: dict[str, GPUMetric] = {}

    def get(self, name: str) -> GPUMetric:
        if name not in self.metrics:
            self.metrics[name] = GPUMetric(name)
        return self.metrics[name]

    def category_totals(self):
        out: dict[str, float] = {}
        for name, m in self.metrics.items():
            cat = next((c for k, c in self.CATEGORIES.items() if k in name),
                       "Other")
            out[cat] = out.get(cat, 0.0) + m.time_elapsed
        return out

    def table(self):
        return {name: round(m.time_elapsed, 3)
                for name, m in self.metrics.items()}
