#!/usr/bin/env python
"""Run the BASELINE.json configs through the scan harness and print one
table.

Usage: python tools/bench_baselines.py [--frames 32]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--only", default="",
                    help="run a subset, comma-separated (e.g. 3,5,7)")
    ap.add_argument("--filter", default="",
                    help="override FramePlan.texture_filter "
                         "(bilinear/trilinear A/B)")
    ap.add_argument("--rec-pack", default="",
                    help="override FramePlan.rec_pack (hilo/u32/f32) — "
                         "shading-record stream layout A/B")
    ap.add_argument("--cloud-impl", default="",
                    help="override RenderConfig.cloud_impl (lut/"
                         "perpixel A/B — prices the LUT deviation)")
    ap.add_argument("--compiler-opt", action="append", default=[],
                    help="key=value XLA compiler option (repeatable), "
                         "for compile-latency experiments")
    args = ap.parse_args()

    import dataclasses

    import jax
    import numpy as np

    from soc_real_time_renderer import scenes
    from soc_real_time_renderer.utils import compile_cache

    compile_cache.enable()
    from soc_real_time_renderer.config import RenderConfig
    from soc_real_time_renderer.graph import frame as frame_mod

    # BASELINE.json configs 1-5
    CONFIGS = [
        (1, "helmet 640x360 G-buffer + direct light + tonemap only",
         "helmet", dict(width=640, height=384, shadow_resolution=1024,
                        enable_ssao=False, enable_bloom=False,
                        enable_clouds=False, enable_taa=False,
                        enable_auto_exposure=False, enable_hiz=False)),
        (2, "helmet + normal mapping + shadow map + SSAO, 1280x720",
         "helmet", dict(width=1280, height=736, shadow_resolution=4096,
                        enable_bloom=False, enable_clouds=False,
                        enable_taa=False, enable_auto_exposure=False,
                        enable_hiz=False)),
        (3, "sponza full screen-space stack, 1280x720",
         "sponza", dict(width=1280, height=736)),
        (4, "terrain + shadow + atmosphere sky, 1920x1080",
         "terrain", dict(width=1920, height=1088)),
        (5, "full scene (sponza+terrain+clouds+TAA+exposure), 1920x1080",
         "full", dict(width=1920, height=1088)),
        # appendix rows: no silent fast-because-dead wins — pay the
        # 4096² shadow raster and the 50-iter SSR march
        (6, "APPENDIX config-2 variant, helmet INSIDE sun volume "
            "(shadow raster actually pays)",
         "helmet_lifted", dict(width=1280, height=736,
                               shadow_resolution=4096,
                               enable_bloom=False, enable_clouds=False,
                               enable_taa=False,
                               enable_auto_exposure=False,
                               enable_hiz=False)),
        (7, "APPENDIX config-3 + SSR computed (reference parity mode)",
         "sponza", dict(width=1280, height=736, enable_ssr=True)),
    ]

    only = {int(s) for s in args.only.split(",") if s.strip()}
    for num, desc, scene, kw in CONFIGS:
        if only and num not in only:
            continue
        cfg = RenderConfig(**kw)
        built = scenes.build(scene, cfg)
        plan = built.plan
        if args.filter:
            plan = dataclasses.replace(plan, texture_filter=args.filter)
        if args.rec_pack:
            plan = dataclasses.replace(plan, rec_pack=args.rec_pack)
        if args.cloud_impl:
            plan = dataclasses.replace(
                plan, config=plan.config.replace(
                    cloud_impl=args.cloud_impl))
        cfg = plan.config
        gs = []
        for i in range(args.frames):
            g, mm, nm = built.frame_globals(i + 1)
            gs.append(g)
        gb = jax.tree_util.tree_map(
            lambda *xs: np.stack([np.asarray(x) for x in xs]), *gs)

        def run(batch, gb, hist, mm, nm, plan=plan):
            def step(h, g):
                out, h2 = frame_mod.render_frame(plan, batch, g, h, mm, nm)
                # frame.bench_probe consumes every enabled pass output
                # (HiZ tops, un-composited SSR) so no pass is silently
                # dead-code-eliminated out of the measured frame
                return h2, (frame_mod.bench_probe(out), out.ssr_active)
            return jax.lax.scan(step, hist, gb)

        copts = dict(kv.split("=", 1) for kv in args.compiler_opt) or None
        runj = jax.jit(run, donate_argnames=("hist",),
                       compiler_options=copts)
        hist = frame_mod.RenderHistory.create(cfg)
        t0 = time.perf_counter()
        _, (probes, ssra) = runj(built.batch, gb, hist, mm, nm)
        float(probes.sum())
        compile_s = time.perf_counter() - t0
        hist = frame_mod.RenderHistory.create(cfg)
        t0 = time.perf_counter()
        _, (probes, ssra) = runj(built.batch, gb, hist, mm, nm)
        float(probes.sum())
        ms = (time.perf_counter() - t0) * 1e3 / args.frames
        tris = built.batch.num_triangles
        mpix = cfg.width * cfg.height / 1e6
        ssra = np.asarray(ssra)
        ssr_s = (f", ssr active {ssra.min()}..{ssra.max()} "
                 f"(cap {plan.ssr_cap})" if ssra.max() >= 0 else "")
        print(f"config {num}: {ms:8.2f} ms/frame  "
              f"({tris/1e3:.0f}k tris, {tris * 1e3 / ms / 1e6:.0f} Mtris/s, "
              f"{mpix * 1e3 / ms:.0f} Mpix/s, compile {compile_s:.0f}s"
              f"{ssr_s})  — {desc}", flush=True)


if __name__ == "__main__":
    main()
