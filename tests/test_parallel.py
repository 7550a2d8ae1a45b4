"""Multi-device validation (SURVEY §2.6 P6) on the virtual 8-device mesh.

Three properties the dryrun alone can't pin:
 * 1-device and 8-device renders of the same cameras are numerically
   equal (the sharding is an implementation detail, not a semantic);
 * the screen-space stack really partitions over rows — the compiled
   sharded shade step contains cross-device halo exchanges and its
   output shards are row-bands, not replicas;
 * the sharded shade step compiles natively (the shade stage is plain
   XLA: no Pallas interpret in the jitted function).

The scene is a small procedural terrain (builds from the repository
alone); chip_smoke.py --four-cards runs the same comparisons on cards.
"""
import dataclasses

import jax
import numpy as np
import pytest

from soc_real_time_renderer import scenes
from soc_real_time_renderer.config import RenderConfig
from soc_real_time_renderer.graph import frame as frame_mod
from soc_real_time_renderer.models import terrain
from soc_real_time_renderer.parallel import mesh as pmesh
from soc_real_time_renderer.scene.components import (MeshComponent,
                                                     TransformComponent)
from soc_real_time_renderer.scene.scene import Scene

CFG = RenderConfig(width=128, height=128, shadow_resolution=128)


def small_terrain(cfg):
    """The terrain preset at one subdivision per patch (~20k tris) and a
    64² atlas: the same passes, sized for the CPU test mesh."""
    hm = terrain.procedural_heightmap(64)
    model = terrain.build_terrain_model(hm, terrain.default_albedo(hm),
                                        tess_level=1)
    scene = Scene("terrain")
    e = scene.create_entity("terrain")
    e.add_component(TransformComponent())
    e.add_component(MeshComponent()).model = model
    return scenes._finish(scene, [model], cfg, camera_pos=[20.0, 12.0, 20.0],
                          camera_target=[50, 0, 50], atlas_size=64)


@pytest.fixture(scope="module")
def built():
    b = small_terrain(CFG)
    b.plan = dataclasses.replace(b.plan, interpret=True)
    return b


def test_one_vs_eight_device_equivalence(built):
    assert len(jax.devices()) >= 8
    mesh = pmesh.make_mesh(8)           # (dp=2, sp=4)
    dp = mesh.shape["dp"]

    plan = built.plan

    # jitted single-device reference (jit-vs-eager fusion reassociation
    # alone is ~1e-4; the property under test is 1-device-jit ==
    # 8-device-jit, not jit == eager)
    single_fn = jax.jit(lambda g, h, mm, nm: frame_mod.render_frame(
        plan, built.batch, g, h, mm, nm)[0].color)

    gs, hs, singles = [], [], []
    _, mm, nm = built.frame_globals(1)
    for i in range(dp):
        g, mm, nm = built.frame_globals(i + 1)
        gs.append(g)
        hs.append(frame_mod.RenderHistory.create(CFG))
        singles.append(np.asarray(single_fn(
            g, frame_mod.RenderHistory.create(CFG), mm, nm)))

    globals_batch = pmesh.batched_globals(gs)
    history_batch = jax.tree_util.tree_map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]), *hs)
    step = pmesh.make_batched_render_fn(plan, mesh)
    with mesh:
        batch, globals_batch, history_batch = pmesh.shard_inputs(
            mesh, built.batch, globals_batch, history_batch)
        colors, _ = step(batch, globals_batch, history_batch, mm, nm)
        colors = np.asarray(colors)

    assert colors.shape == (dp, 3, CFG.height, CFG.width)
    for i in range(dp):
        np.testing.assert_allclose(colors[i], singles[i], atol=1e-5,
                                   err_msg=f"camera {i}")


def test_sharded_raster_resolve_row_bands(built):
    """The raster RESOLVE (the pixel×triangle coverage work) splits over
    bin rows under SPMD with row-band output shards
    (raster2.resolve_row_sharded).  This is the P6 item the round-2
    verdict flagged: the geometry stage's cost must scale with devices,
    not replicate.  Two pins: (a) the full raster_stage matches the
    jitted single-device stage to float tolerance on every pixel (the
    replicated setup math may compile with different fusion under SPMD,
    so a near-tie edge pixel may flip tri_id — bounded below); (b) the
    resolve kernel itself, fed the SAME starts/record arrays, is
    bit-identical to the unsharded resolve.  The reference is jitted,
    as in test_one_vs_eight_device_equivalence: against the eager stage
    one silhouette pixel of this terrain flips its winner and moves
    depth by 1.3e-3 (setup fusion, not sharding); against the jitted
    stage the sharded raster is bit-identical on the CPU."""
    from soc_real_time_renderer.ops import raster2

    mesh = pmesh.make_mesh(8, dp=1)
    plan = dataclasses.replace(built.plan, shard_mesh=mesh,
                               shard_axis="sp")
    g, mm, nm = built.frame_globals(1)

    vis_ref, *_ = jax.jit(lambda *a: frame_mod.raster_stage(
        built.plan, *a))(built.batch, g, mm, nm)
    with mesh:
        vis_sh, *_ = jax.jit(lambda *a: frame_mod.raster_stage(plan, *a))(
            built.batch, g, mm, nm)
        np.testing.assert_allclose(np.asarray(vis_sh.depth),
                                   np.asarray(vis_ref.depth), atol=2e-5)
        flips = (np.asarray(vis_sh.tri_id)
                 != np.asarray(vis_ref.tri_id)).mean()
        assert flips < 0.005, f"tri_id flips on {flips:.2%} of pixels"

    # the uncropped resolve output must be genuinely row-band sharded
    grid = built.plan.main_grid
    setup = raster2.triangle_setup_planar(
        frame_mod._clip_of(frame_mod.transform_triangles(
            built.batch, mm, nm)[0], g.camera.projection_view),
        grid.width, grid.height, "front")
    import dataclasses as dc
    BYp = -(-grid.by // 8) * 8
    grid_p = dc.replace(grid, height=BYp * grid.bh)
    starts, st, _ = raster2.build_pairs(setup, grid_p)
    _, rstream, _ = raster2.pair_stream(setup, grid_p)
    rgrid = raster2.stream_grid(grid_p, built.batch.num_triangles)
    d_ref, t_ref = raster2.resolve(starts, rstream, rgrid, interpret=True)
    with mesh:
        d_sh, t_sh = jax.jit(lambda s, r: raster2.resolve_row_sharded(
            s, r, rgrid, mesh, "sp", interpret=True))(starts, rstream)
        shard_shapes = {s.data.shape for s in d_sh.addressable_shards}
        np.testing.assert_array_equal(np.asarray(d_sh), np.asarray(d_ref))
        np.testing.assert_array_equal(np.asarray(t_sh), np.asarray(t_ref))
    assert shard_shapes == {(BYp // 8 * grid.bh, grid.bx * grid.bw)}, \
        shard_shapes


def test_sharded_shade_distributes_rows(built):
    mesh = pmesh.make_mesh(8, dp=1)     # sp=8: 16-row bands at H=128
    plan_x = dataclasses.replace(
        built.plan, config=built.plan.config.replace(
            cloud_noise_mode="procedural"))

    g, mm, nm = built.frame_globals(1)
    hist = frame_mod.RenderHistory.create(CFG)
    vis, records, shadow_map, overflow = frame_mod.raster_stage(
        built.plan, built.batch, g, mm, nm)

    # reference: unsharded jitted shade
    ref = np.asarray(jax.jit(
        lambda *a: frame_mod.shade_stage(plan_x, *a)[0].color)(
        built.batch, g, hist, vis, records, shadow_map, overflow))

    shade = pmesh.make_sharded_shade_fn(plan_x, mesh)
    lowered = shade.lower(built.batch, g, hist, vis, records, shadow_map,
                          overflow)
    compiled = lowered.compile()
    hlo = compiled.as_text()
    assert "interpret" not in hlo.lower() or "custom-call" not in hlo, \
        "sharded shade must compile natively"
    # halo exchanges for the row-split stencils (blur/TAA/bloom shifts)
    assert ("collective-permute" in hlo) or ("all-gather" in hlo), \
        "no cross-device communication found — stack is not distributed"

    with mesh:
        color, _ = shade(built.batch, g, hist, vis, records, shadow_map,
                         overflow)
    # output shards must be row bands, not replicas
    shard_shapes = {s.data.shape for s in color.addressable_shards}
    assert shard_shapes == {(3, CFG.height // 8, CFG.width)}, shard_shapes
    # far below the u8 output quantum (1/255 ≈ 3.9e-3) — bit-identity
    # across shardings is not a goal: reduction reassociation (bloom
    # convolution partials, exposure histogram psums) moves a few
    # pixels by ~1e-5
    err = np.abs(np.asarray(color) - ref)
    assert float(err.max()) < 2.5e-3, float(err.max())
    assert float((err > 1e-4).mean()) < 1e-3, \
        f"{(err > 1e-4).mean():.2e} of pixels beyond reassociation noise"
