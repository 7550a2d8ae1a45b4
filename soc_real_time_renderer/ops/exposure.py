"""Histogram-based auto exposure.

Port of ``generate_luminance_histogram.inl:50-80`` and
``resolve_luminance_histogram.inl:46-83``: 256-bin log-luminance
histogram (black pixels < 1e-3 land in bin 0 via log2 -> -inf), weighted
mean over non-black bins, ``exposure_target = log2(target / 2^mean)``,
exponential smoothing ``alpha = 1 - exp(-dt * speed)``.

Atomics + shared-memory tree reduction become one deterministic
compare-and-reduce histogram + dot product — the data-parallel shape of
the same computation (SURVEY.md §2.6 P2).

NOTE: the reference pre-remaps log_min/log_max at startup
(renderer.cpp:100-102) which *inverts* the range (log_min > log_max);
the histogram and resolve use the same endpoints so the pipeline is
self-consistent.  We faithfully use whatever is in ShaderGlobals.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..config import AUTO_EXPOSURE_BIN_COUNT

LUMA = jnp.array([0.2126, 0.7152, 0.0722], jnp.float32)


def luminance_histogram(hdr, log_min, log_max):
    """hdr: (3, H, W) -> (256,) int32 histogram."""
    # exact elementwise luminance (no dot, so no TF32 question)
    lum = (LUMA[0] * hdr[0] + LUMA[1] * hdr[1]
           + LUMA[2] * hdr[2]).reshape(-1)
    log_l = jnp.log2(jnp.maximum(lum, 1e-30))
    n = AUTO_EXPOSURE_BIN_COUNT
    mapped = (log_l - log_min) / (log_max - log_min) * (n - 2) + 1.0
    idx = jnp.clip(mapped.astype(jnp.int32), 0, n - 1)
    # black pixels land in bin 0 (generate_luminance_histogram.inl:68-69
    # sets lum = 0 so its log2 underflows to the first bin; we assign
    # explicitly instead of relying on i32(-inf) conversion behaviour)
    idx = jnp.where(lum < 1e-3, 0, idx)
    # compare+reduce histogram (no scatter)
    onehot = idx[:, None] == jnp.arange(n, dtype=jnp.int32)[None, :]
    return jnp.sum(onehot.astype(jnp.int32), axis=0)


def resolve_exposure(hist, prev_exposure, g, num_pixels: int):
    """hist: (256,) -> new smoothed exposure (scalar f32)."""
    n = AUTO_EXPOSURE_BIN_COUNT
    weighted = jnp.sum(hist.astype(jnp.float32)
                       * jnp.arange(n, dtype=jnp.float32))
    black = hist[0].astype(jnp.float32)
    mean_bin = weighted / jnp.maximum(float(num_pixels) - black, 1.0)
    # remap [1, 256] -> [log_min, log_max] (resolve:73-74 uses end1=256)
    log2_mean = ((mean_bin - 1.0) / (n - 1.0)
                 * (g.log_max_luminance - g.log_min_luminance)
                 + g.log_min_luminance)
    target = jnp.log2(g.target_luminance / jnp.exp2(log2_mean))
    alpha = jnp.clip(1.0 - jnp.exp(-g.delta_time * g.adjustment_speed),
                     0.0, 1.0)
    return prev_exposure + (target - prev_exposure) * alpha


def auto_exposure(hdr, prev_exposure, g):
    """Full T16+T17: returns the new exposure scalar."""
    hist = luminance_histogram(hdr, g.log_min_luminance, g.log_max_luminance)
    H, W = hdr.shape[1:]
    return resolve_exposure(hist, prev_exposure, g, H * W)
