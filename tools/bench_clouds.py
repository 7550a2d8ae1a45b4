#!/usr/bin/env python
"""Price tag for the per-pixel cloud deviation: the two cloud
implementations alone at the production scale (config-5 half-res
960x544, QUADRANT quirk dims 1920x1088):

  - LUT path:   render_sky_lut (256x128 march) + sky_from_lut lookup
  - per-pixel:  render_clouds (the exact cloud_rendering.inl port,
                24-step march + sun visibility + atmosphere per pixel)

Timing: device-side scan with carry perturbation + float() readback.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from soc_real_time_renderer import config as cfgm, scenes
from soc_real_time_renderer.ops import clouds

REPS = int(os.environ.get("REPS", "8"))
W = int(os.environ.get("W", "1920"))
H = int(os.environ.get("H", "1088"))
HW, HH = W // 2, H // 2


def timed(fn):
    """fn(c) must FOLD the f32 carry c into a live input (anti-LICM:
    an unperturbed march would hoist out of the scan, PERF.md)."""
    def body(c, _):
        out = fn(c)
        s = sum(jnp.sum(o) for o in jax.tree_util.tree_leaves(out))
        return c + s * 1e-30, s
    runj = jax.jit(lambda a: jax.lax.scan(
        body, a, None, length=REPS)[1])
    t0 = time.perf_counter()
    float(runj(jnp.float32(0)).sum())
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    float(runj(jnp.float32(0)).sum())
    return (time.perf_counter() - t0 - 0.027) * 1e3 / REPS, compile_s


def main():
    built = scenes.build("full", cfgm.RenderConfig(width=W, height=H))
    g, _, _ = built.frame_globals(8)
    noise = built.batch.cloud_noise
    assert noise is not None
    depth = jnp.ones((H, W), jnp.float32)   # all-sky mask: worst case

    ms, cs = timed(
        lambda c: clouds.render_sky_lut(g, noise_tex=noise + c * 1e-30))
    print(f"sky LUT march (256x128)           {ms:8.2f} ms  "
          f"(compile {cs:.0f}s)")
    lut = clouds.render_sky_lut(g, noise_tex=noise)
    ms2, cs2 = timed(
        lambda c: clouds.sky_from_lut(g, lut + c * 1e-30, depth, HW, HH,
                                      full_width=W, full_height=H))
    print(f"LUT lookup at {HW}x{HH}            {ms2:8.2f} ms  "
          f"(compile {cs2:.0f}s)")
    print(f"LUT total                         {ms + ms2:8.2f} ms")

    ms3, cs3 = timed(
        lambda c: clouds.render_clouds(g, depth, noise + c * 1e-30, HW, HH,
                                       full_width=W, full_height=H))
    print(f"per-pixel march at {HW}x{HH}       {ms3:8.2f} ms  "
          f"(compile {cs3:.0f}s)")
    print(f"per-pixel / LUT ratio             {ms3 / max(ms + ms2, 1e-9):8.1f}x")


if __name__ == "__main__":
    main()
