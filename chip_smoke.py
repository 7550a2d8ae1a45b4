#!/usr/bin/env python
"""Quickest proof that the renderer runs on the GPU.

    python chip_smoke.py                # one card: phases 1-4
    python chip_smoke.py --four-cards   # four cards: phase 5 only

Phases, all in this one process (a second JAX process could not get
the card's memory):

1. device check: the first JAX device must be a GPU; prints the card's
   name and power limit as nvidia-smi reports them;
2. kernel parity at real widths: the raster resolve (full and
   depth-only), compiled for the card, against the float64 numpy
   oracle (tests/raster_oracle.py) and against the plain-jnp resolve
   (raster2.resolve_xla) on seeded soups of 20,000 well-shaped
   triangles, and against the plain resolve alone on random soups of
   20,000 triangles (slivers included), at 1920x1088 and 4096x4096;
3. main path: the terrain preset at 1920x1088 (4096² shadow map) —
   compile, then 8 animated frames — and the procedural atrium (the
   multi-material texture path) for 4 frames;
4. card against CPU: the same terrain frames at 640x384 rendered on the
   card and on this process's CPU backend;
5. (--four-cards, and then nothing else) the batched render step on a
   dp=2 x sp=2 mesh against single-card renders of the same cameras,
   and the raster resolve split over 4 row bands against one card.

Any failed check exits non-zero before the result line.  The last line
of standard output is one JSON object: ok, and the device platform,
kind and count as JAX reports them.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(name, ok, detail):
    print(f"[{'ok' if ok else 'FAIL'}] {name}: {detail}", flush=True)
    if not ok:
        fail(name)


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"nvidia-smi: {e}")
    if out.returncode != 0:
        fail(f"nvidia-smi exited {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip()


def render(built, plan, gls, device=None):
    """Compile on the first of the per-frame inputs `gls` (from
    BuiltScene.frame_globals), then render the rest; returns (outputs,
    compile_s, ms_per_frame).  `device` pins the frame to one device
    (the CPU comparison).  Frames are dispatched back to back and the
    clock stops at block_until_ready of the last one."""
    import jax
    from soc_real_time_renderer.graph import frame as fm
    put = (lambda x: jax.device_put(x, device)) if device else jax.device_put
    batch = put(built.batch)
    gls = [put(x) for x in gls]
    f = jax.jit(lambda b, g, h, mm, nm: fm.render_frame(plan, b, g, h,
                                                        mm, nm),
                donate_argnums=(2,))
    hist = put(fm.RenderHistory.create(plan.config))
    g, mm, nm = gls[0]
    t0 = time.perf_counter()
    out, hist = f(batch, g, hist, mm, nm)
    jax.block_until_ready(out.color)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for g, mm, nm in gls[1:]:
        out, hist = f(batch, g, hist, mm, nm)
    jax.block_until_ready(out.color)
    ms = (time.perf_counter() - t0) * 1e3 / max(len(gls) - 1, 1)
    return out, compile_s, ms


def frames_of(built, n):
    return [built.frame_globals(i + 1) for i in range(n)]


def check_frame(name, out):
    import numpy as np
    c = np.asarray(out.color)
    ov = int(out.overflow)
    check(f"{name} output", np.isfinite(c).all() and float(c.std()) > 1e-3
          and ov == 0,
          f"shape {c.shape}, finite {bool(np.isfinite(c).all())}, "
          f"std {float(c.std()):.4f}, mean {float(c.mean()):.4f}, "
          f"overflow bits {ov}")
    return c


# (label, width, height, grid preset, soup triangle size)
PARITY_CASES = (("1920x1088", 1920, 1088, "main", 0.05),
                ("4096x4096", 4096, 4096, "shadow", 0.03))


def kernel_vs_plain(tag, setup, grid, n, depth_only):
    """The compiled kernel against raster2.resolve_xla on the same pair
    stream: ids on > 0.9999 of pixels, depth within 1e-6."""
    import jax
    import numpy as np
    from soc_real_time_renderer.ops import raster2

    starts, recs, ov = jax.jit(
        raster2.pair_stream, static_argnums=1)(setup, grid)
    check(f"{tag} stream overflow", int(ov) == 0, f"bits {int(ov)}")
    rgrid = raster2.stream_grid(grid, n)
    xd, xt = jax.jit(raster2.resolve_xla, static_argnames=(
        "grid", "depth_only"))(starts, recs, grid=rgrid,
                               depth_only=depth_only)
    pd, pt = jax.jit(raster2.resolve, static_argnames=(
        "grid", "depth_only"))(starts, recs, grid=rgrid,
                               depth_only=depth_only)
    derr = float(np.abs(np.asarray(pd) - np.asarray(xd)).max())
    idm = 1.0 if depth_only else float(
        (np.asarray(pt) == np.asarray(xt)).mean())
    check(f"{tag} vs plain jnp resolve", idm > 0.9999 and derr <= 1e-6,
          f"id match {idm:.6f}, max depth diff {derr:.2e}")


def phase_parity(cases=PARITY_CASES, n=20000):
    """Per size: on a soup of well-shaped triangles, the kernel against
    the float64 oracle and against the plain resolve; on a random soup
    (slivers included, whose f32 setup error exceeds the oracle bound
    at 4096²), the kernel against the plain resolve only."""
    import jax.numpy as jnp
    import numpy as np
    from raster_oracle import naive_raster, regular_soup, soup
    from soc_real_time_renderer import scenes
    from soc_real_time_renderer.ops import raster2

    for label, W, H, kind, size in cases:
        clip, planar = regular_soup(n, seed=W, size=size, aspect=W / H)
        t0 = time.perf_counter()
        od, ot = naive_raster(clip, np.arange(3 * n).reshape(n, 3), W, H,
                              cull="none")
        oracle_s = time.perf_counter() - t0
        grid = scenes._cap_grid(raster2.default_grid(W, H, kind=kind), n)
        planar = jnp.asarray(planar)
        full_depth = None
        for depth_only in (False, True):
            tag = f"resolve{'-depth' if depth_only else ''} {label}"
            vis, setup = raster2.rasterize_jit(planar, grid, "none", None,
                                               None, False, depth_only)
            kd = np.asarray(vis.depth)
            check(f"{tag} overflow", int(vis.overflow) == 0,
                  f"bits {int(vis.overflow)}")
            if depth_only:
                # same records, same per-pixel arithmetic: the id-free
                # kernel must reproduce the full kernel's depth
                derr = float(np.abs(kd - full_depth).max())
                check(f"{tag} vs full kernel", derr <= 1e-6,
                      f"max depth diff {derr:.2e}")
            else:
                kt = np.asarray(vis.tri_id)
                same = kt == ot
                derr = float(np.abs(kd - od)[same].max())
                check(f"{tag} vs oracle",
                      same.mean() > 0.999 and derr < 1e-4,
                      f"id match {same.mean():.6f}, max depth err where "
                      f"ids agree {derr:.2e} (oracle {oracle_s:.1f} s)")
                full_depth = kd
            kernel_vs_plain(tag, setup, grid, n, depth_only)

        _, planar = soup(n, seed=W, extent=size, aspect=W / H)
        setup = raster2.triangle_setup_planar(jnp.asarray(planar), W, H,
                                              "none")
        for depth_only in (False, True):
            kernel_vs_plain(
                f"resolve{'-depth' if depth_only else ''} {label} "
                f"random soup", setup, grid, n, depth_only)


def phase_main(width=1920, height=1088):
    from soc_real_time_renderer import scenes
    from soc_real_time_renderer.config import RenderConfig

    t0 = time.perf_counter()
    built = scenes.build("terrain", RenderConfig(width=width, height=height))
    built.animate = True
    build_s = time.perf_counter() - t0
    out, compile_s, ms = render(built, built.plan, frames_of(built, 9))
    print(f"terrain {width}x{height}: build {build_s:.1f} s, compile "
          f"{compile_s:.1f} s, {ms:.3f} ms/frame over 8 frames, shadow "
          f"raster {'elided (statically empty)' if built.plan.shadow_statically_empty else 'ran'}",
          flush=True)
    check_frame(f"terrain {width}x{height}", out)

    t0 = time.perf_counter()
    atrium = scenes.build("atrium", RenderConfig(width=width, height=height))
    build_s = time.perf_counter() - t0
    n_mat = atrium.batch.atlas_packed.shape[0] // atrium.plan.atlas_layer_stride
    check("atrium atlas is multi-material", n_mat >= 2, f"{n_mat} materials")
    out, compile_s, ms = render(atrium, atrium.plan, frames_of(atrium, 5))
    print(f"atrium {width}x{height} ({atrium.batch.num_triangles} tris, "
          f"{n_mat} materials): build "
          f"{build_s:.1f} s, compile {compile_s:.1f} s, {ms:.3f} ms/frame "
          f"over 4 frames", flush=True)
    check_frame(f"atrium {width}x{height}", out)


def phase_card_vs_cpu(width=640, height=384):
    import jax
    import numpy as np
    from soc_real_time_renderer import scenes
    from soc_real_time_renderer.config import RenderConfig

    built = scenes.build("terrain", RenderConfig(width=width, height=height))
    built.animate = True
    gls = frames_of(built, 4)
    out_gpu, _, _ = render(built, built.plan, gls)
    cpu = jax.devices("cpu")[0]
    # the CPU is the device here, so the resolve runs interpreted
    with jax.default_device(cpu):
        out_cpu, compile_s, ms = render(
            built, dataclasses.replace(built.plan, interpret=True), gls,
            device=cpu)
    a = check_frame(f"terrain {width}x{height} card", out_gpu)
    b = check_frame(f"terrain {width}x{height} cpu", out_cpu)
    d = np.abs(a - b)
    mean, p99 = float(d.mean()), float(np.percentile(d, 99))
    check(f"terrain {width}x{height} card vs cpu",
          mean < 2 / 255 and p99 < 12 / 255,
          f"mean |diff| {mean * 255:.3f}/255, p99 {p99 * 255:.3f}/255 "
          f"(cpu frame {ms:.0f} ms)")


def phase_four_cards(width=1920, height=1088):
    import jax
    import numpy as np
    from soc_real_time_renderer import scenes
    from soc_real_time_renderer.config import RenderConfig
    from soc_real_time_renderer.graph import frame as fm
    from soc_real_time_renderer.parallel import mesh as pmesh

    if len(jax.devices()) < 4:
        fail(f"--four-cards needs 4 devices, found {len(jax.devices())}")
    cfg = RenderConfig(width=width, height=height)
    built = scenes.build("terrain", cfg)
    built.animate = True
    plan = built.plan
    mesh = pmesh.make_mesh(4, dp=2)
    dp = mesh.shape["dp"]
    gls = [built.frame_globals(i + 1) for i in range(dp)]
    _, mm, nm = gls[0]
    single = jax.jit(lambda g, h, mm, nm: fm.render_frame(
        plan, built.batch, g, h, mm, nm)[0].color)
    singles = [np.asarray(single(g, fm.RenderHistory.create(cfg), mm, nm))
               for g, _, _ in gls]
    hist = jax.tree_util.tree_map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]),
        *[fm.RenderHistory.create(cfg) for _ in range(dp)])
    step = pmesh.make_batched_render_fn(plan, mesh)
    with mesh:
        batch, gb, hb = pmesh.shard_inputs(
            mesh, built.batch, pmesh.batched_globals([g for g, _, _ in gls]),
            hist)
        t0 = time.perf_counter()
        colors, _ = step(batch, gb, hb, mm, nm)
        colors = np.asarray(colors)
        step_s = time.perf_counter() - t0
    for i in range(dp):
        d = np.abs(colors[i] - singles[i])
        mean, p99 = float(d.mean()), float(np.percentile(d, 99))
        check(f"dp=2 x sp=2 camera {i} vs one card",
              np.isfinite(colors[i]).all() and mean < 2 / 255
              and p99 < 12 / 255,
              f"mean |diff| {mean * 255:.4f}/255, p99 {p99 * 255:.4f}/255, "
              f"max {float(d.max()) * 255:.3f}/255 (first step incl. "
              f"compile {step_s:.1f} s)")

    mesh4 = pmesh.make_mesh(4, dp=1)
    g, mm, nm = gls[0]
    ref = jax.jit(lambda *a: fm.raster_stage(plan, *a)[0])(
        built.batch, g, mm, nm)
    plan4 = dataclasses.replace(plan, shard_mesh=mesh4, shard_axis="sp")
    with mesh4:
        vis = jax.jit(lambda *a: fm.raster_stage(plan4, *a)[0])(
            built.batch, g, mm, nm)
        d4, t4 = np.asarray(vis.depth), np.asarray(vis.tri_id)
        bands = sorted({s.data.shape for s in vis.depth.addressable_shards})
    # the replicated setup may compile with other fusion under SPMD, so
    # a near-tie pixel may flip its winner (bounded); depth is compared
    # on every pixel
    derr = float(np.abs(d4 - np.asarray(ref.depth)).max())
    flips = float((t4 != np.asarray(ref.tri_id)).mean())
    check("resolve over 4 row bands vs one card",
          derr <= 2e-5 and flips < 0.005,
          f"max depth diff {derr:.2e}, tri_id flips {flips:.4%}, band "
          f"shards {bands}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "soc_real_time_renderer")):
        fail("chip_smoke.py must run from a checkout of the repository")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

    import jax
    from soc_real_time_renderer.utils import compile_cache
    compile_cache.enable()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"no GPU: JAX's first device is {devs[0]}")
    print(f"card: {card_line()}", flush=True)
    print(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}",
          flush=True)

    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        for name, phase in (("kernel parity", phase_parity),
                            ("main path", phase_main),
                            ("card vs cpu", phase_card_vs_cpu)):
            t1 = time.perf_counter()
            phase()
            print(f"phase {name}: {time.perf_counter() - t1:.1f} s",
                  flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
