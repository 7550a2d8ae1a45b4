"""The statically-empty sun-shadow proof and its analytic composition.

The reference's shadow volume never contains any scene geometry (the
GLM ZO macros are misspelled -> [-1,1] depth mode, and the sun sits 40
units above a +-16 ortho box: renderer.cpp:108-133, pch.hpp:17,
camera.hpp:5), so its 4096^2 map stays at the 1.0 clear and
sun_shadow = exp(-80(z-1)) ~ 0.  We reproduce the output while
statically eliding the dead raster + ESM gather; these tests pin the
proof and the output equivalence.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np

from soc_real_time_renderer import config as cfgm
from soc_real_time_renderer import scenes
from soc_real_time_renderer.config import RenderConfig
from soc_real_time_renderer.graph import frame as fm
from soc_real_time_renderer.ops import composition as comp


def test_helmet_scene_proves_empty_and_matches_raster_path():
    cfg = RenderConfig(width=128, height=128, shadow_resolution=128)
    built = scenes.build("helmet", cfg)
    assert built.plan.shadow_statically_empty, \
        "helmet at y~0 under the y=40 sun must prove empty"
    plan_e = dataclasses.replace(
        built.plan,
        main_grid=dataclasses.replace(built.plan.main_grid,
                                      pair_cap=65536, med_cap=1024),
        shadow_grid=dataclasses.replace(built.plan.shadow_grid,
                                        pair_cap=65536, med_cap=1024),
        interpret=True)
    plan_r = dataclasses.replace(plan_e, shadow_statically_empty=False)
    g, mm, nm = built.frame_globals(1)
    hist = fm.RenderHistory.create(cfg)

    out_e, _ = fm.render_frame(plan_e, built.batch, g, hist, mm, nm)
    out_r, _ = fm.render_frame(plan_r, built.batch, g, hist, mm, nm)

    # the rasterized map really is empty (all at the 1.0 clear) ...
    assert out_e.shadow_map is None
    np.testing.assert_array_equal(np.asarray(out_r.shadow_map), 1.0)
    # ... and the analytic path is output-identical
    np.testing.assert_allclose(np.asarray(out_e.color),
                               np.asarray(out_r.color), atol=1e-6)


def test_in_volume_geometry_defeats_the_proof():
    from soc_real_time_renderer.models import proc
    from soc_real_time_renderer.models.scene_batch import \
        build_scene_batch
    batch, _ = build_scene_batch([proc.unit_quad(z=-1.0, size=0.5)],
                                 atlas_size=64)
    # identity transform: quad at z=-1 near the origin -> z_sun ~ 1.78,
    # outside [0,1] -> empty
    eye = np.eye(4, dtype=np.float32)[None]
    assert scenes._shadow_statically_empty(batch, eye)[0]
    # lift it into the sun volume (y ~ 40 - 8 = 32, inside the +-16
    # z planes around the y=40 sun) -> proof must fail
    lifted = eye.copy()
    lifted[0, 1, 3] = 32.0
    assert not scenes._shadow_statically_empty(batch, lifted)[0]


def test_non_default_sun_rejected_when_elided():
    """A caller-supplied sun that differs from the proved one must be
    rejected, not silently composed against the 1.0 map (ADVICE r2)."""
    import pytest
    cfg = RenderConfig(width=128, height=128, shadow_resolution=128)
    built = scenes.build("helmet", cfg)
    assert built.plan.shadow_statically_empty
    assert built.plan.proved_sun_pv is not None
    g, mm, nm = built.frame_globals(1)
    hist = fm.RenderHistory.create(cfg)
    plan = dataclasses.replace(built.plan, interpret=True)
    # default sun passes the guard (trace only; eval_shape avoids compute)
    fm.check_sun_proof(plan, g)
    # a moved sun must raise before any rendering happens
    bad_sun = cfgm.SunInfo.create(position=(0.0, 10.0, 0.0))
    g_bad = dataclasses.replace(g, sun=bad_sun)
    with pytest.raises(ValueError, match="different"):
        fm.render_frame(plan, built.batch, g_bad, hist, mm, nm)


def test_batched_render_fn_also_guards_the_sun_proof():
    """make_batched_render_fn jits render_frame directly (the sun is a
    Tracer inside, so check_sun_proof cannot compare there) — its host
    wrapper must apply the same guard make_render_fn does, per batched
    camera."""
    import jax
    import pytest
    from soc_real_time_renderer.parallel import mesh as pmesh
    cfg = RenderConfig(width=128, height=128, shadow_resolution=128)
    built = scenes.build("helmet", cfg)
    assert built.plan.shadow_statically_empty
    mesh = pmesh.make_mesh(min(2, len(jax.devices())), dp=1)
    plan = dataclasses.replace(built.plan, interpret=True)
    step = pmesh.make_batched_render_fn(plan, mesh)
    g, mm, nm = built.frame_globals(1)
    bad_sun = cfgm.SunInfo.create(position=(0.0, 10.0, 0.0))
    g_bad = dataclasses.replace(g, sun=bad_sun)
    globals_batch = pmesh.batched_globals([g_bad])
    hist = fm.RenderHistory.create(cfg)
    history_batch = jax.tree_util.tree_map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]), *[hist])
    with pytest.raises(ValueError, match="different"):
        step(built.batch, globals_batch, history_batch, mm, nm)


def test_empty_map_composition_matches_all_ones_map():
    """compose(empty_shadow_map=True) == compose with a literal all-1.0
    map, including the volumetric branch."""
    rng = np.random.default_rng(3)
    H, W, S = 16, 32, 64
    from soc_real_time_renderer.camera import Camera3D, camera_matrices
    cam = Camera3D()
    cam.resize(W, H)
    g = cfgm.ShaderGlobals.create(
        camera=camera_matrices(cam, [0, 0, 2], 1, W, H))
    depth = jnp.asarray(rng.random((H, W), dtype=np.float32) * 0.4 + 0.5)
    alb = jnp.asarray(rng.random((3, H, W), dtype=np.float32))
    emi = jnp.zeros((3, H, W), jnp.float32)
    nrm = jnp.zeros((3, H, W), jnp.float32).at[2].set(1.0)
    ssao = jnp.ones((H, W), jnp.float32)
    ones_map = jnp.ones((S, S), jnp.float32)
    for vol in (False, True):
        a = comp.compose(g, depth, alb, emi, nrm, ssao, ones_map, None,
                         enable_volumetric=vol, max_point_lights=0,
                         max_spot_lights=0)
        b = comp.compose(g, depth, alb, emi, nrm, ssao, None, None,
                         enable_volumetric=vol, max_point_lights=0,
                         max_spot_lights=0, empty_shadow_map=True)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-6, err_msg=f"vol={vol}")


def test_shadow_crop_bit_identical():
    """The static ESM sampling crop (FramePlan.shadow_crop) must be
    provably lossless: the paid-shadow scene renders bit-identically
    with the crop on and off."""
    cfg = RenderConfig(width=128, height=128, shadow_resolution=512,
                       enable_ssao=False, enable_bloom=False,
                       enable_clouds=False, enable_taa=False,
                       enable_auto_exposure=False, enable_hiz=False)
    built = scenes.build("helmet_lifted", cfg)
    plan = built.plan
    assert not plan.shadow_statically_empty
    assert plan.shadow_crop is not None, "lifted helmet must get a crop"
    x0, y0, w, h = plan.shadow_crop
    assert w * h < 512 * 512          # crop genuinely smaller
    g, mm, nm = built.frame_globals(1)
    out_c, _ = fm.render_frame(plan, built.batch, g,
                               fm.RenderHistory.create(cfg), mm, nm)
    plan_full = dataclasses.replace(plan, shadow_crop=None)
    out_f, _ = fm.render_frame(plan_full, built.batch, g,
                               fm.RenderHistory.create(cfg), mm, nm)
    np.testing.assert_array_equal(np.asarray(out_c.color),
                                  np.asarray(out_f.color))
