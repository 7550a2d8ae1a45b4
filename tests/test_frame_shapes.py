"""Whole-frame shape/trace check via eval_shape (fast CI guard: catches
layout/broadcast regressions without compiling or running kernels)."""
import dataclasses

import jax
import numpy as np
import pytest

from soc_real_time_renderer import config as cfgm
from soc_real_time_renderer.camera import Camera3D, camera_matrices
from soc_real_time_renderer.graph import frame as fm
from soc_real_time_renderer.models import proc
from soc_real_time_renderer.models.scene_batch import build_scene_batch


def _setup(width=256, height=128, **cfg_kw):
    cfg = cfgm.RenderConfig(width=width, height=height,
                            shadow_resolution=256, **cfg_kw)
    batch, atlas = build_scene_batch([proc.unit_quad()], atlas_size=64)
    plan = fm.FramePlan.create(cfg, atlas, interpret=True)
    plan = dataclasses.replace(
        plan,
        main_grid=dataclasses.replace(plan.main_grid, pair_cap=1024,
                                      med_cap=64),
        shadow_grid=dataclasses.replace(plan.shadow_grid, pair_cap=1024,
                                        med_cap=64))
    cam = Camera3D()
    cam.resize(width, height)
    cm = camera_matrices(cam, [0, 0, 1.5], 1, width, height)
    g = cfgm.ShaderGlobals.create(camera=cm, camera_prev=cm)
    hist = fm.RenderHistory.create(cfg)
    mm = np.eye(4, dtype=np.float32)[None]
    return plan, batch, g, hist, mm


@pytest.mark.parametrize("cfg_kw", [
    {},                                            # default pipeline
    {"enable_ssr": True, "composite_ssr": True},
    {"enable_depth_of_field": True},
    {"enable_volumetric_light": True},
    {"enable_shadows": False, "enable_bloom": False, "enable_taa": False,
     "enable_ssao": False, "enable_clouds": False,
     "enable_auto_exposure": False},
    {"cloud_impl": "perpixel"},     # reference per-pixel march wiring
])
def test_render_frame_shapes(cfg_kw):
    plan, batch, g, hist, mm = _setup(**cfg_kw)
    out, hist2 = jax.eval_shape(
        lambda b, gg, h, m, n: fm.render_frame(plan, b, gg, h, m, n),
        batch, g, hist, mm, mm)
    H, W = plan.config.height, plan.config.width
    assert out.color.shape == (3, H, W)
    assert out.hdr.shape == (3, H, W)
    assert out.gbuffer.velocity.shape == (2, H, W)
    assert hist2.previous_color.shape == (3, H, W)
    assert hist2.exposure.shape == ()
    # HiZ pyramids ride every frame (renderer.cpp:988-1001 parity):
    # level 0 half-res, last level 1x1
    assert out.hiz_min[0].shape == (H // 2, W // 2)
    assert out.hiz_max[-1].shape == (1, 1)
    assert out.overflow.shape == ()
    assert out.ssr_active.shape == ()


@pytest.mark.parametrize("stub", ["resolve", "raster", "shadow_resolve",
                                  "records", "unlit"])
def test_attribution_stubs_run(stub):
    """The bench_toggle substitution stubs (VERDICT r3 item 1) must
    trace, run, and stay finite — a stub that crashes on chip wastes a
    250 s compile."""
    plan, batch, g, hist, mm = _setup()
    plan = dataclasses.replace(plan, stub=stub)
    out, hist2 = fm.render_frame(plan, batch, g, hist, mm, mm)
    assert np.isfinite(np.asarray(out.color)).all()
    assert out.color.shape == (3, plan.config.height, plan.config.width)


def test_vis_barrier_identical_output():
    """vis_barrier is a scheduling probe only — pixels must not move."""
    plan, batch, g, hist, mm = _setup()
    out_a, _ = fm.render_frame(plan, batch, g, hist, mm, mm)
    hist_b = fm.RenderHistory.create(plan.config)
    # plan defaults vis_barrier=True, so the A/B must exercise False
    # (ADVICE r4: comparing the default against replace(..., True) was
    # vacuous)
    out_b, _ = fm.render_frame(dataclasses.replace(plan, vis_barrier=False),
                               batch, g, hist_b, mm, mm)
    np.testing.assert_array_equal(np.asarray(out_a.color),
                                  np.asarray(out_b.color))


def test_rec_pack_u32_identical_output():
    """The u32-packed record stream carries the SAME bf16 hi/lo bit
    patterns as the hilo layout (gbuffer.build_shading_records pack=
    "u32"), so the reconstructed f32 records — and every pixel — must
    match.  Tolerance 1e-6, not exact: the unpack fuses differently
    and XLA may FMA-contract downstream chains differently (same
    reassociation caveat as ssr-compact-vs-dense)."""
    plan, batch, g, hist, mm = _setup()
    out_a, _ = fm.render_frame(plan, batch, g, hist, mm, mm)
    hist_b = fm.RenderHistory.create(plan.config)
    out_b, _ = fm.render_frame(dataclasses.replace(plan, rec_pack="u32"),
                               batch, g, hist_b, mm, mm)
    np.testing.assert_allclose(np.asarray(out_a.color),
                               np.asarray(out_b.color), atol=1e-6)


def test_rec_pack_f32_close_output():
    """pack="f32" skips the bf16 hi/lo split entirely — the records
    carry ~8 extra mantissa bits beyond what hi+lo reconstructs, so
    output is CLOSE to the hilo default (which is itself pinned
    against the oracle by the golden tests), not bit-equal.  The
    hi/lo residual recovers ~16 mantissa bits, so any divergence is
    at interpolation noise level."""
    plan, batch, g, hist, mm = _setup()
    out_a, _ = fm.render_frame(plan, batch, g, hist, mm, mm)
    hist_b = fm.RenderHistory.create(plan.config)
    out_b, _ = fm.render_frame(dataclasses.replace(plan, rec_pack="f32"),
                               batch, g, hist_b, mm, mm)
    a = np.asarray(out_a.color, np.float32)
    b = np.asarray(out_b.color, np.float32)
    assert float(np.abs(a - b).mean()) < 2e-3
    assert float(np.abs(a - b).max()) < 0.1
