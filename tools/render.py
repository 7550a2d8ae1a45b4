#!/usr/bin/env python
"""Headless renderer CLI — the Application/main-loop analog.

Usage:
  python tools/render.py --scene terrain --width 1920 --height 1088 \
      --frames 8 --out out/frame.png [--platform cpu] [--dump-passes]

Builds the scene (SURVEY.md application.cpp:14-28 analog), runs N frames
through the jitted frame graph and dumps the final frame (and optionally
every intermediate pass).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="terrain",
                    choices=["terrain", "atrium", "helmet", "sponza",
                             "full", "helmet_lifted"])
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--out", default="out/frame.png")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--dump-passes", action="store_true")
    ap.add_argument("--no-shadows", action="store_true")
    ap.add_argument("--pair-cap", type=int, default=None,
                    help="override BinGrid.pair_cap (debug: exercise "
                         "the overflow detector)")
    args = ap.parse_args()

    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform

    import numpy as np
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from soc_real_time_renderer import scenes
    from soc_real_time_renderer.utils import compile_cache

    compile_cache.enable()
    from soc_real_time_renderer.config import RenderConfig
    from soc_real_time_renderer.graph import frame as frame_mod
    from soc_real_time_renderer.utils import image_io

    cfg = RenderConfig(width=args.width, height=args.height)
    if args.no_shadows:
        cfg = cfg.replace(enable_shadows=False)

    built = scenes.build(args.scene, cfg)
    if args.pair_cap is not None:
        import dataclasses
        built.plan = dataclasses.replace(
            built.plan,
            main_grid=dataclasses.replace(built.plan.main_grid,
                                          pair_cap=args.pair_cap),
            shadow_grid=dataclasses.replace(built.plan.shadow_grid,
                                            pair_cap=args.pair_cap))
    render = frame_mod.make_render_fn(built.plan)
    history = frame_mod.RenderHistory.create(cfg)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    t_compile = None
    for i in range(args.frames):
        g, mm, nm = built.frame_globals(i)
        t0 = time.perf_counter()
        outputs, history = render(built.batch, g, history, mm, nm)
        jax.block_until_ready(outputs.color)
        dt = time.perf_counter() - t0
        if i == 0:
            t_compile = dt
        print(f"frame {i}: {dt*1e3:.2f} ms")

    image_io.save_png(args.out, np.asarray(outputs.color))
    print(f"wrote {args.out} (first-frame incl. compile: {t_compile*1e3:.0f} ms)")
    ov = int(outputs.overflow)
    if ov:
        bits = [name for bit, name in [(1, "PAIRS"), (2, "MED_CAP"),
                                       (4, "MED_SLOTS"),
                                       (16, "SSR_CAP")] if ov & bit]
        print(f"WARNING: static caps overflowed ({'|'.join(bits)}) — "
              f"fragments/SSR rays were dropped; raise BinGrid caps or "
              f"FramePlan.ssr_cap (scenes.py)")

    if args.dump_passes:
        base = os.path.splitext(args.out)[0]
        gb = outputs.gbuffer
        for name, img in [
                ("albedo", gb.albedo), ("emissive", gb.emissive),
                ("normal", np.asarray(gb.normal) * 0.5 + 0.5),
                ("depth", np.repeat(np.asarray(gb.depth)[None], 3, 0)),
                ("velocity", None), ("hdr", outputs.hdr)]:
            if name == "velocity":
                v = np.asarray(gb.velocity)
                img = np.concatenate([np.abs(v) * 20.0,
                                      np.zeros_like(v[:1])], 0)
            image_io.save_png(f"{base}_{name}.png", np.asarray(img))
        if outputs.shadow_map is not None:
            image_io.save_png(
                f"{base}_shadow.png",
                np.repeat(np.asarray(outputs.shadow_map)[None], 3, 0))
        print(f"dumped passes to {base}_*.png")


if __name__ == "__main__":
    main()
