#!/usr/bin/env python
"""Dump the OPTIMIZED HLO of one frame (post-fusion, post-scheduling)
for offline analysis: which fusions duplicate the record gather
in-frame, and what a toggle (HiZ off, no texture tap) changes in the
schedule.

Compiles via jit(...).lower(...).compile().as_text(), so the text comes
back to the calling process without --xla_dump_to.

Usage:
  python tools/dump_hlo.py --config 5 --out out/r5/hlo5_hiz1.txt
  python tools/dump_hlo.py --config 5 --hiz-off --out out/r5/hlo5_hiz0.txt
  python tools/dump_hlo.py --config 3 --out out/r5/hlo3.txt
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

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
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=5)
    ap.add_argument("--hiz-off", action="store_true")
    ap.add_argument("--tex-none", action="store_true",
                    help="texture_filter='none' variant (the tex_none "
                         "attribution stub) for in-frame diffing")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    import jax
    import numpy as np
    import dataclasses

    from soc_real_time_renderer import scenes
    from soc_real_time_renderer.config import RenderConfig
    from soc_real_time_renderer.graph import frame as fm
    from soc_real_time_renderer.utils import compile_cache
    compile_cache.enable()

    scene, kw = PRESETS[args.config]
    built = scenes.build(scene, RenderConfig(**kw))
    plan = built.plan
    if args.hiz_off:
        plan = dataclasses.replace(
            plan, config=plan.config.replace(enable_hiz=False))
    if args.tex_none:
        plan = dataclasses.replace(plan, texture_filter="none")
    g, mm, nm = built.frame_globals(1)
    hist = fm.RenderHistory.create(plan.config)

    def one(batch, g, hist, mm, nm):
        out, h2 = fm.render_frame(plan, batch, g, hist, mm, nm)
        return fm.bench_probe(out), h2

    lowered = jax.jit(one).lower(built.batch, g, hist, mm, nm)
    compiled = lowered.compile()
    txt = compiled.as_text()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(txt)
    ca = compiled.cost_analysis() or {}
    print(f"wrote {args.out}: {len(txt)/1e6:.1f} MB, "
          f"{txt.count(chr(10))} lines, "
          f"flops={ca.get('flops', 0)/1e9:.2f}G "
          f"bytes={ca.get('bytes accessed', 0)/1e9:.2f}GB", flush=True)


if __name__ == "__main__":
    main()
