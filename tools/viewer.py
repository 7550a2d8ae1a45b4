#!/usr/bin/env python
"""Interactive viewer entry point (the main.cpp analog for live use)."""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="terrain")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--platform", default=None,
                    help="jax platform override (e.g. cpu)")
    args = ap.parse_args()

    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
        import jax
        jax.config.update("jax_platforms", args.platform)

    from soc_real_time_renderer import scenes
    from soc_real_time_renderer.config import RenderConfig
    from soc_real_time_renderer.graph import frame as frame_mod
    from soc_real_time_renderer.ui import server
    from soc_real_time_renderer.utils import compile_cache

    compile_cache.enable()

    cfg = RenderConfig(width=args.width, height=args.height,
                       shadow_resolution=1024)
    built = scenes.build(args.scene, cfg)
    render = frame_mod.make_render_fn(built.plan)
    history = frame_mod.RenderHistory.create(cfg)
    server.serve(built, render, history, port=args.port)


if __name__ == "__main__":
    main()
