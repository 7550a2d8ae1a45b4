#!/usr/bin/env python
"""In-frame per-pass attribution: bench.py's scan harness with pass
toggles (the isolated profiler under-measures passes whose input
chains hoist).

For each toggle, runs the full scan-harness frame with that pass
disabled and reports the delta vs the baseline config.  A pass's true
in-frame cost INCLUDES the fusion glue it drags in, which isolation
hides.

Usage:
  python tools/bench_toggle.py --scene full --width 1920 --height 1088 \
      [--toggles shadows,ssao,...] [--frames 16]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="full")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--config", type=int, default=0,
                    help="use BASELINE config N's scene + flags "
                         "(overrides --scene/--width/--height)")
    ap.add_argument("--toggles", default=(
        "shadows,ssao,bloom,clouds,taa,auto_exposure,hiz"))
    args = ap.parse_args()

    # BASELINE.json presets (keep in sync with tools/bench_baselines.py)
    PRESETS = {
        1: ("helmet", dict(width=640, height=384, shadow_resolution=1024,
                           enable_ssao=False, enable_bloom=False,
                           enable_clouds=False, enable_taa=False,
                           enable_auto_exposure=False, enable_hiz=False)),
        2: ("helmet", dict(width=1280, height=736, shadow_resolution=4096,
                           enable_bloom=False, enable_clouds=False,
                           enable_taa=False, enable_auto_exposure=False,
                           enable_hiz=False)),
        3: ("sponza", dict(width=1280, height=736)),
        4: ("terrain", dict(width=1920, height=1088)),
        5: ("full", dict(width=1920, height=1088)),
        6: ("helmet_lifted", dict(width=1280, height=736,
                                  shadow_resolution=4096,
                                  enable_bloom=False, enable_clouds=False,
                                  enable_taa=False,
                                  enable_auto_exposure=False,
                                  enable_hiz=False)),
    }

    import dataclasses

    import jax
    import numpy as np

    from soc_real_time_renderer.utils import compile_cache
    compile_cache.enable()

    from soc_real_time_renderer import scenes
    from soc_real_time_renderer.config import RenderConfig
    from soc_real_time_renderer.graph import frame as frame_mod

    if args.config:
        scene_name, kw = PRESETS[args.config]
        built = scenes.build(scene_name, RenderConfig(**kw))
    else:
        built = scenes.build(
            args.scene, RenderConfig(width=args.width, height=args.height))
    # the scene build tunes the config (static scene-true light counts,
    # terrain toggle); variants MUST derive from the tuned config or the
    # baseline silently reverts to 128+128 empty light scans
    cfg0 = built.plan.config

    gs = []
    for i in range(args.frames):
        g, mm, nm = built.frame_globals(i + 1)
        gs.append(g)
    globals_batch = jax.tree_util.tree_map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]), *gs)

    def measure(cfg, **plan_kw):
        plan = dataclasses.replace(built.plan, config=cfg, **plan_kw)

        def run(batch, gb, hist, mm, nm):
            def step(h, g):
                out, h2 = frame_mod.render_frame(plan, batch, g, h, mm, nm)
                # see frame.bench_probe for the probe-liveness rules
                return h2, frame_mod.bench_probe(out)
            return jax.lax.scan(step, hist, gb)

        runj = jax.jit(run, donate_argnames=("hist",))
        hist = frame_mod.RenderHistory.create(cfg)
        t0 = time.perf_counter()
        _, probes = runj(built.batch, globals_batch, hist, mm, nm)
        float(probes.sum())
        compile_s = time.perf_counter() - t0
        hist = frame_mod.RenderHistory.create(cfg)
        t0 = time.perf_counter()
        _, probes = runj(built.batch, globals_batch, hist, mm, nm)
        float(probes.sum())
        return (time.perf_counter() - t0) * 1e3 / args.frames, compile_s

    base_ms, cs = measure(cfg0)
    print(f"{'baseline':24s} {base_ms:8.2f} ms/frame  (compile {cs:.0f}s)",
          flush=True)

    variants = {
        "shadows": cfg0.replace(enable_shadows=False),
        "ssao": cfg0.replace(enable_ssao=False),
        "bloom": cfg0.replace(enable_bloom=False),
        "clouds": cfg0.replace(enable_clouds=False),
        "taa": cfg0.replace(enable_taa=False),
        "auto_exposure": cfg0.replace(enable_auto_exposure=False),
        "hiz": cfg0.replace(enable_hiz=False),
        # texture-filter plan variants: "tex_none" skips the atlas
        # gather entirely (constant texel) — its delta IS the in-frame
        # atlas tap cost; "tex_trilinear" doubles the tap.
        "tex_none": (cfg0, dict(texture_filter="none")),
        "tex_nearest": (cfg0, dict(texture_filter="nearest")),
        "tex_trilinear": (cfg0, dict(texture_filter="trilinear")),
        # stage-level substitution stubs: each
        # replaces ONE stage with a cheap synthetic producer while
        # keeping the rest of the frame (and the stubbed stage's
        # upstream) live — delta = that stage's in-frame cost.  See
        # FramePlan.stub for semantics.
        "stub_resolve": (cfg0, dict(stub="resolve")),
        "stub_raster": (cfg0, dict(stub="raster")),
        "stub_shadow_resolve": (cfg0, dict(stub="shadow_resolve")),
        "stub_records": (cfg0, dict(stub="records")),
        "unlit": (cfg0, dict(stub="unlit")),
        # vis-barrier probes: "no_visbar" drops the default barrier
        "no_visbar": (cfg0, dict(vis_barrier=False)),
        "visbar_nohiz": (cfg0.replace(enable_hiz=False),
                         dict(vis_barrier=True)),
    }
    for name in args.toggles.split(","):
        if name not in variants:
            print(f"{name:24s} (unknown toggle)")
            continue
        v = variants[name]
        if isinstance(v, tuple):
            ms, cs = measure(v[0], **v[1])
        else:
            ms, cs = measure(v)
        plain = (name.endswith("_xla")
                 or name.startswith(("stub_", "tex_", "vis"))
                 or name == "unlit")
        tag = name if plain else "-" + name
        print(f"{tag:24s} {ms:8.2f} ms/frame  delta {base_ms - ms:+8.2f}"
              f"  (compile {cs:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
