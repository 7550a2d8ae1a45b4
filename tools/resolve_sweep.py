#!/usr/bin/env python
"""Time the raster resolve's tunables on the card.

    python tools/resolve_sweep.py [--defaults]

Views: the terrain and atrium main views at 1920x1088 (full resolve)
and a seeded 4096x4096 soup (depth-only, the shadow view's kernel).
Stage A sweeps bin shape x chunk at the default pixel block and warp
count; stage B sweeps pixel block x warps at the best stage-A pair
whose binning did not overflow.  --defaults sweeps chunk x pixel block
x warps at the default bin shapes only.
Every line gives the resolve kernel's median ms, the whole raster's
(setup + binning + record gather + resolve) median ms, and the
kernel's agreement with the plain-jnp resolve (raster2.resolve_xla)
on the same pair stream.  Needs a GPU.
"""
import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def median_ms(f, *args, n=10):
    import jax
    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    return ts[len(ts) // 2]


def views():
    import jax.numpy as jnp
    from raster_oracle import soup
    from soc_real_time_renderer import scenes
    from soc_real_time_renderer.config import RenderConfig
    from soc_real_time_renderer.graph import frame as fm
    out = []
    for name in ("terrain", "atrium"):
        b = scenes.build(name, RenderConfig(width=1920, height=1088))
        g, mm, nm = b.frame_globals(1)
        world, _ = fm.transform_triangles(b.batch, mm, nm)
        clip = fm._clip_of(world, g.camera.projection_view)
        out.append((name, clip, 1920, 1088, "front", False,
                    b.batch.num_triangles))
    _, planar = soup(20000, seed=4096, extent=0.03)
    out.append(("soup4096-depth", jnp.asarray(planar), 4096, 4096, "none",
                True, 20000))
    return out


def stream(view, bw, bh):
    """Setup + binning + record gather for one bin shape (chunk-64
    padding serves every chunk <= 64); prints its median ms."""
    import jax
    from soc_real_time_renderer import scenes
    from soc_real_time_renderer.ops import raster2
    name, clip, W, H, cull, depth_only, T = view
    grid = scenes._cap_grid(raster2.BinGrid(
        width=W, height=H, bin_w=bw, bin_h=bh, chunk=64), T)

    def f(c):
        setup = raster2.triangle_setup_planar(c, W, H, cull)
        return raster2.pair_stream(setup, grid)

    f = jax.jit(f)
    ms = median_ms(f, clip)
    starts, recs, ov = f(clip)
    print(f"{name} bins {bw}x{bh}: binning + record gather {ms:.4f} ms, "
          f"pairs {int(starts[-1])}, overflow {int(ov)}", flush=True)
    return starts, recs, raster2.stream_grid(grid, T), ms, int(ov)


def run(view, st, chunk, block_px, warps, ref):
    """Times one kernel variant on a stream; returns (resolve ms, ref)
    or None when the compiler refuses the variant."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    import numpy as np
    from soc_real_time_renderer.ops import raster2
    name, clip, W, H, cull, depth_only, T = view
    starts, recs, grid, s_ms, _ = st
    grid = dataclasses.replace(grid, chunk=chunk)
    row0 = jnp.zeros((1,), jnp.int32)
    tag = (f"{name} bins {grid.bw}x{grid.bh} chunk {chunk} px {block_px} "
           f"warps {warps}")

    def kern(s, r):
        return raster2._pallas_resolve(s, r, grid, False, row0,
                                       depth_only, block_px, warps)

    try:
        k = jax.jit(kern)
        k_ms = median_ms(k, starts, recs)
    except Exception as e:          # a variant the compiler refuses
        print(f"{tag}: ERROR {type(e).__name__}: {str(e)[:300]}",
              flush=True)
        return None
    d, t = k(starts, recs)
    if ref is None:
        xla = jax.jit(lambda s, r: raster2.resolve_xla(
            s, r, grid, depth_only=depth_only))
        print(f"{name} bins {grid.bw}x{grid.bh}: plain-jnp resolve "
              f"{median_ms(xla, starts, recs, n=3):.4f} ms", flush=True)
        xd, xt = xla(starts, recs)
        ref = (np.asarray(xd)[:H, :W],
               None if xt is None else np.asarray(xt)[:H, :W])
    derr = float(np.abs(np.asarray(d)[:H, :W] - ref[0]).max())
    idm = 1.0 if t is None else float(
        (np.asarray(t)[:H, :W] == ref[1]).mean())
    print(f"{tag}: resolve {k_ms:.4f} ms, raster {s_ms + k_ms:.4f} ms, "
          f"vs plain: id match {idm:.6f}, max depth diff {derr:.2e}",
          flush=True)
    return k_ms, ref


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--defaults", action="store_true",
                    help="sweep chunk x pixel block x warps at the "
                         "default bin shapes only")
    args = ap.parse_args()
    import jax
    from soc_real_time_renderer.ops import raster2
    from soc_real_time_renderer.utils import compile_cache
    compile_cache.enable()
    if jax.devices()[0].platform != "gpu":
        sys.exit("resolve_sweep needs a GPU")
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    for view in views():
        name, clip, W, H, cull, depth_only, T = view
        base = raster2.default_grid(W, H, kind="shadow" if depth_only
                                    else "main")
        if args.defaults:
            st = stream(view, base.bw, base.bh)
            ref = None
            for chunk in (16, 32):
                for block_px in (64, 128):
                    for warps in (4, 8):
                        r = run(view, st, chunk, block_px, warps, ref)
                        ref = ref if r is None else r[1]
            continue
        shapes = ([(128, 128), (64, 64), (32, 32)] if depth_only else
                  [(64, 32), (64, 64), (32, 32), (32, 16), (16, 16)])
        best, ref, streams = None, None, {}
        for bw, bh in shapes:
            streams[bw, bh] = st = stream(view, bw, bh)
            for chunk in (16, 32, 64):
                r = run(view, st, chunk, *raster2.LAUNCH[depth_only], ref)
                if r is None:
                    continue
                ref = r[1]
                total = st[3] + r[0]
                if st[4] == 0 and (best is None or total < best[0]):
                    best = (total, bw, bh, chunk)
        if best is None:
            continue
        _, bw, bh, chunk = best
        print(f"{name}: best stage-A raster without overflow "
              f"{best[0]:.4f} ms at bins {bw}x{bh} chunk {chunk}",
              flush=True)
        for block_px in (64, 128, 256):
            for warps in (2, 4, 8):
                if block_px // bw > bh:
                    continue
                run(view, streams[bw, bh], chunk, block_px, warps, ref)


if __name__ == "__main__":
    main()
