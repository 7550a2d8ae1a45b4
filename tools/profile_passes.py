#!/usr/bin/env python
"""Per-pass timing table — the GPUMetric HUD analog (SURVEY.md §5).

Runs each pass's jitted sub-function in isolation over the real scene's
intermediates and prints a table + category totals, amortizing the
dispatch floor with a device-side repeat loop.

Usage: python tools/profile_passes.py --scene terrain --width 1920 \
           --height 1088 [--filter bilinear]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="terrain")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--filter", default="bilinear")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from soc_real_time_renderer.utils import compile_cache
    compile_cache.enable()

    from soc_real_time_renderer import scenes
    from soc_real_time_renderer.config import RenderConfig
    from soc_real_time_renderer.graph import frame as fm
    from soc_real_time_renderer.ops import (bloom, composition, exposure,
                                            gbuffer, raster2, ssao, taa,
                                            tonemap)
    from soc_real_time_renderer.utils.metrics import GPUMetricPool

    cfg = RenderConfig(width=args.width, height=args.height)
    built = scenes.build(args.scene, cfg)
    plan = built.plan
    g, mm, nm = built.frame_globals(1)
    batch = built.batch
    hist = fm.RenderHistory.create(cfg)

    pool = GPUMetricPool()

    def timed(name, fn, *inputs):
        def rep(*a):
            def body(i, c):
                # make the first float input depend on the carry so XLA
                # can neither hoist the body (LICM) nor dead-code any
                # output
                perturbed = []
                done = False
                for x in a:
                    if (not done and hasattr(x, "dtype")
                            and x.dtype == jnp.float32):
                        perturbed.append(x + c * 1e-30)
                        done = True
                    else:
                        perturbed.append(x)
                r = fn(*perturbed)
                tot = jnp.float32(0)
                for leaf in jax.tree_util.tree_leaves(r):
                    tot += jnp.sum(leaf.astype(jnp.float32)) * 1e-30
                return c + tot
            return jax.lax.fori_loop(0, args.iters, body, jnp.float32(0))
        f = jax.jit(rep)
        t0 = time.perf_counter()
        jax.block_until_ready(f(*inputs))
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(f(*inputs))
        ms = (time.perf_counter() - t0) * 1e3 / args.iters
        pool.get(name).time_elapsed = ms
        print(f"{name:28s} {ms:9.3f} ms   (compile {compile_s:.0f}s)",
              flush=True)
        return ms

    # stage inputs (computed once, device-resident)
    world, wnrm = fm.transform_triangles(batch, jnp.asarray(mm),
                                         jnp.asarray(nm))
    clip = fm._clip_of(world, g.camera.projection_view)
    sclip = fm._clip_of(world, g.sun.projection_view)
    vis, setup = raster2.rasterize(clip, plan.main_grid, "front")
    records = gbuffer.build_shading_records(setup, world, wnrm, batch.tri_uv,
                                            batch.static_rows)
    gbuf = gbuffer.resolve_gbuffer(
        vis, records, batch.atlas_packed, g.camera_prev.projection_view,
        atlas_size=plan.atlas_size, layer_stride=plan.atlas_layer_stride,
        n_levels=plan.atlas_n_levels, filter_mode=args.filter)
    svis, _ = raster2.rasterize(sclip, plan.shadow_grid, "back")
    jax.block_until_ready(gbuf.albedo)

    timed("vertex+transform", lambda b, m, n: fm.transform_triangles(
        b, m, n)[0], batch, jnp.asarray(mm), jnp.asarray(nm))
    timed("raster main (visibility)",
          lambda c: raster2.rasterize(c, plan.main_grid, "front")[0].depth,
          clip)
    timed("raster shadow",
          lambda c: raster2.rasterize(c, plan.shadow_grid, "back")[0].depth,
          sclip)
    timed("g-buffer resolve",
          lambda v, r, a: gbuffer.resolve_gbuffer(
              v, r, a, g.camera_prev.projection_view,
              atlas_size=plan.atlas_size,
              layer_stride=plan.atlas_layer_stride,
              n_levels=plan.atlas_n_levels,
              filter_mode=args.filter).albedo,
          vis, records, batch.atlas_packed)
    timed("bloom", lambda e: bloom.bloom(e, cfg.bloom_mip_count),
          gbuf.emissive)
    timed("ssao+blur",
          lambda d, n: ssao.ssao_blur(ssao.ssao_generate(d, n, g)),
          vis.depth, gbuf.normal)
    from soc_real_time_renderer.ops import clouds as clouds_ops
    timed("clouds sky-lut", lambda: clouds_ops.render_sky_lut(g))
    lut = clouds_ops.render_sky_lut(g)
    timed("clouds lookup",
          lambda l, d: clouds_ops.sky_from_lut(g, l, d, cfg.width // 2,
                                               cfg.height // 2,
                                               full_width=cfg.width,
                                               full_height=cfg.height),
          lut, vis.depth)
    ssao_full = jnp.ones_like(vis.depth)
    # pass the scene's STATIC light counts like render_frame does — the
    # default 128+128 empty scan slots would add artifact time
    pcfg = plan.config
    timed("composition",
          lambda d, a, e, n, s, sm: composition.compose(
              g, d, a, e, n, s, sm, None,
              max_point_lights=pcfg.max_point_lights,
              max_spot_lights=pcfg.max_spot_lights), vis.depth, gbuf.albedo,
          gbuf.emissive, gbuf.normal, ssao_full, svis.depth)
    hdr = composition.compose(g, vis.depth, gbuf.albedo, gbuf.emissive,
                              gbuf.normal, ssao_full, svis.depth, None,
                              max_point_lights=pcfg.max_point_lights,
                              max_spot_lights=pcfg.max_spot_lights)
    timed("luminance histogram+resolve",
          lambda h_: exposure.auto_exposure(h_, jnp.float32(0.0), g), hdr)
    timed("taa", lambda c, d, v, pc, pv: taa.taa(
        c, d, v, pc, pv, g.frame_counter),
        hdr, vis.depth, gbuf.velocity, jnp.asarray(hist.previous_color),
        jnp.asarray(hist.previous_velocity))
    timed("tonemap", lambda c: tonemap.tone_map(c, jnp.float32(0.0), g), hdr)

    print("\ncategory totals (ms):")
    for cat, ms in sorted(pool.category_totals().items()):
        print(f"  {cat:16s} {ms:8.3f}")
    print(f"  {'SUM':16s} {sum(pool.category_totals().values()):8.3f}")


if __name__ == "__main__":
    main()
