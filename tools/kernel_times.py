#!/usr/bin/env python
"""In-frame costs on the card: each hand-written kernel against what XLA
makes of its plain version, and the XLA passes that replaced the
removed kernels.

    python tools/kernel_times.py [--frames 16]

Terrain and atrium at 1920x1088 (4096² shadow map), animated cameras,
frames dispatched back to back and ended by block_until_ready:

* raster resolve: the Triton kernel against raster2.resolve_xla, whole
  frames, in turns (kernel, plain, plain, kernel);
* SSAO, TAA, clouds/sky: the frame with the pass against the frame
  without it (the difference is the pass's in-frame cost);
* texture tap: the atrium frame (five materials) with the bilinear tap
  against the tap replaced by a constant (filter "none");
* sky LUT with a seeded 64x64 noise table, alone;
* bloom's banded contractions at default precision against HIGHEST:
  time and largest difference.
Needs a GPU.
"""
import argparse
import contextlib
import dataclasses
import functools
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT]


def median_ms(f, *args, n=20):
    import jax
    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    return ts[len(ts) // 2]


class Frames:
    """One scene's per-frame inputs on the device, shared by variants."""

    def __init__(self, built, n):
        import jax
        self.built = built
        self.gls = [jax.device_put(built.frame_globals(i + 1))
                    for i in range(n + 1)]

    def compile(self, plan):
        """-> (run(), compile_s): run() renders the frames and returns
        ms/frame."""
        import jax
        from soc_real_time_renderer.graph import frame as fm
        f = jax.jit(functools.partial(fm.render_frame, plan),
                    donate_argnames=("history",))
        batch = self.built.batch

        def frames(gls):
            h = fm.RenderHistory.create(plan.config)
            out = None
            for g, mm, nm in gls:
                out, h = f(batch, g, h, mm, nm)
            jax.block_until_ready(out.color)

        t0 = time.perf_counter()
        frames(self.gls[:1])
        compile_s = time.perf_counter() - t0

        def run():
            frames(self.gls[:1])
            t0 = time.perf_counter()
            frames(self.gls[1:])
            return (time.perf_counter() - t0) * 1e3 / (len(self.gls) - 1)

        return run, compile_s


@contextlib.contextmanager
def plain_resolve():
    """Trace frames with raster2.resolve_xla in place of the kernel."""
    from soc_real_time_renderer.ops import raster2
    kernel = raster2.resolve

    def plain(starts, recs, grid, interpret=None, row0=None,
              depth_only=False):
        return raster2.resolve_xla(starts, recs, grid, row0=row0,
                                   depth_only=depth_only)

    raster2.resolve = plain
    try:
        yield
    finally:
        raster2.resolve = kernel


def report(name, ms, compile_s=None):
    extra = "" if compile_s is None else f" (compile {compile_s:.1f} s)"
    print(f"{name}: {ms:.4f} ms/frame{extra}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16)
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp
    import numpy as np
    from soc_real_time_renderer import scenes
    from soc_real_time_renderer.config import RenderConfig
    from soc_real_time_renderer.ops import bloom as bloom_ops
    from soc_real_time_renderer.ops import clouds as clouds_ops
    from soc_real_time_renderer.utils import compile_cache
    compile_cache.enable()
    if jax.devices()[0].platform != "gpu":
        sys.exit("kernel_times needs a GPU")
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)

    cfg = RenderConfig(width=1920, height=1088)
    terrain = scenes.build("terrain", cfg)
    terrain.animate = True
    tf = Frames(terrain, args.frames)
    plan = terrain.plan
    print(f"terrain: {terrain.batch.num_triangles} tris, shadow raster "
          f"{'elided' if plan.shadow_statically_empty else 'paid'}",
          flush=True)

    # raster resolve: kernel vs plain jnp, in turns
    kern, c_k = tf.compile(plan)
    with plain_resolve():
        plain, c_p = tf.compile(plan)
    for name, run in (("kernel", kern), ("plain", plain),
                      ("plain", plain), ("kernel", kern)):
        report(f"terrain frame, {name} resolve", run(),
               c_k if name == "kernel" else c_p)

    # passes that replaced removed kernels: frame with vs without
    base = kern()
    report("terrain frame, all passes", base)
    for flag in ("enable_ssao", "enable_taa", "enable_clouds"):
        run, _ = tf.compile(dataclasses.replace(
            plan, config=plan.config.replace(**{flag: False})))
        ms = run()
        report(f"terrain frame without {flag[7:]}", ms)
        print(f"  {flag[7:]} in-frame cost {base - ms:.4f} ms", flush=True)

    # texture tap in the multi-material atrium
    atrium = scenes.build("atrium", cfg)
    af = Frames(atrium, args.frames)
    a_run, a_c = af.compile(atrium.plan)
    none_run, _ = af.compile(dataclasses.replace(atrium.plan,
                                                 texture_filter="none"))
    tri_run, _ = af.compile(dataclasses.replace(
        atrium.plan, texture_filter="trilinear"))
    a_ms = a_run()
    report(f"atrium frame ({atrium.batch.num_triangles} tris, "
           f"{atrium.batch.atlas_packed.shape[0] // atrium.plan.atlas_layer_stride}"
           " materials), bilinear tap",
           a_ms, a_c)
    n_ms = none_run()
    report("atrium frame, constant texel (no tap)", n_ms)
    print(f"  bilinear tap in-frame cost {a_ms - n_ms:.4f} ms", flush=True)
    t_ms = tri_run()
    report("atrium frame, trilinear tap", t_ms)
    with plain_resolve():
        ap_run, _ = af.compile(atrium.plan)
    report("atrium frame, plain resolve", ap_run())
    report("atrium frame, kernel resolve", a_run())

    # sky LUT with a seeded noise table, alone
    g = jax.device_put(terrain.frame_globals(1)[0])
    noise = jnp.asarray(np.random.default_rng(0).random((64, 64),
                                                        np.float32))
    lut_tex = jax.jit(lambda g, t: clouds_ops.render_sky_lut(g, noise_tex=t))
    lut_proc = jax.jit(clouds_ops.render_sky_lut)
    print(f"sky LUT 256x128, seeded 64x64 noise table: "
          f"{median_ms(lut_tex, g, noise):.4f} ms; procedural noise: "
          f"{median_ms(lut_proc, g):.4f} ms", flush=True)

    # bloom: default precision vs HIGHEST
    emissive = jnp.asarray(np.random.default_rng(1).random(
        (3, cfg.height, cfg.width), np.float32) ** 8 * 4.0)
    b_def = jax.jit(lambda e: bloom_ops.bloom(e, cfg.bloom_mip_count))
    b_def(emissive)                      # traced at the module's setting
    default = bloom_ops.MATMUL_PRECISION
    bloom_ops.MATMUL_PRECISION = jax.lax.Precision.HIGHEST
    b_hi = jax.jit(lambda e: bloom_ops.bloom(e, cfg.bloom_mip_count))
    b_hi(emissive)
    bloom_ops.MATMUL_PRECISION = default
    d = float(jnp.abs(b_def(emissive) - b_hi(emissive)).max())
    scale = float(jnp.abs(b_hi(emissive)).max())
    print(f"bloom {cfg.width}x{cfg.height}: default precision "
          f"{median_ms(b_def, emissive):.4f}"
          f" ms, HIGHEST {median_ms(b_hi, emissive):.4f} ms, max |diff| "
          f"{d:.3e} of max {scale:.3e}", flush=True)


if __name__ == "__main__":
    main()
