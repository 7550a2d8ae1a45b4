"""Golden-statistics test: a tiny scene through the FULL frame graph.

The reference had no automated tests (SURVEY.md §4); its visual
iteration maps to these executable goldens: render a deterministic tiny
scene end-to-end (all passes on) and pin image statistics.  Statistics
rather than exact pixels keep the test robust to benign re-orderings
while still catching semantic regressions in any pass.
"""
import dataclasses

import numpy as np
import pytest

from soc_real_time_renderer import config as cfgm
from soc_real_time_renderer.camera import Camera3D, camera_matrices
from soc_real_time_renderer.graph import frame as fm
from soc_real_time_renderer.models import proc
from soc_real_time_renderer.models.scene_batch import build_scene_batch


@pytest.fixture(scope="module")
def tiny_frame():
    cfg = cfgm.RenderConfig(width=128, height=64, shadow_resolution=128,
                            enable_clouds=False,  # cloud march is slow on CPU
                            max_point_lights=0, max_spot_lights=0)
    batch, atlas = build_scene_batch([proc.unit_quad(z=-1.0, size=0.6)],
                                     atlas_size=64)
    plan = fm.FramePlan.create(cfg, atlas, interpret=True)
    plan = dataclasses.replace(
        plan,
        main_grid=dataclasses.replace(plan.main_grid, pair_cap=1024,
                                      med_cap=64),
        shadow_grid=dataclasses.replace(plan.shadow_grid, pair_cap=1024,
                                        med_cap=64))
    cam = Camera3D()
    cam.resize(cfg.width, cfg.height)
    import soc_real_time_renderer.utils.mathutil as mu
    cam.view_mat = mu.look_at([0, 0, 1.0], [0, 0, -1], [0, 1, 0])
    cm = camera_matrices(cam, [0, 0, 1.0], 1, cfg.width, cfg.height)
    g = cfgm.ShaderGlobals.create(camera=cm, camera_prev=cm,
                                  frame_counter=np.int32(1))
    hist = fm.RenderHistory.create(cfg)
    mm = np.eye(4, dtype=np.float32)[None]
    out, hist2 = fm.render_frame(plan, batch, g, hist, mm, mm)
    return out, hist2


def test_geometry_coverage(tiny_frame):
    out, _ = tiny_frame
    d = np.asarray(out.gbuffer.depth)
    hit = d < 1.0
    # quad of half-size 0.6 at z=-1 from a camera at z=1 (dist 2),
    # fov 90, aspect 2 -> ndc x ±0.15, y ±0.3 -> 4.5% coverage
    assert 0.03 < hit.mean() < 0.07
    # centred
    ys, xs = np.nonzero(hit)
    assert abs(xs.mean() - 63.5) < 2.0 and abs(ys.mean() - 31.5) < 2.0


def test_gbuffer_contents(tiny_frame):
    out, _ = tiny_frame
    alb = np.asarray(out.gbuffer.albedo)
    nrm = np.asarray(out.gbuffer.normal)
    hit = np.asarray(out.gbuffer.depth) < 1.0
    # untextured material falls back to white albedo
    np.testing.assert_allclose(alb[:, hit], 1.0, atol=2e-2)
    # sky clear colour elsewhere
    np.testing.assert_allclose(alb[0][~hit], 0.2, atol=2e-2)
    np.testing.assert_allclose(alb[2][~hit], 1.0, atol=2e-2)
    # flat +z normal
    np.testing.assert_allclose(nrm[2, hit], 1.0, atol=1e-3)
    # velocity ~ 0 (identical prev camera)
    np.testing.assert_allclose(np.asarray(out.gbuffer.velocity)[:, hit],
                               0.0, atol=1e-3)


def test_lighting_and_tonemap(tiny_frame):
    out, _ = tiny_frame
    color = np.asarray(out.color)
    assert np.isfinite(color).all()
    assert 0.0 <= color.min() and color.max() <= 1.0
    hdr = np.asarray(out.hdr)
    hit = np.asarray(out.gbuffer.depth) < 1.0
    # sun (0,-1,0)-ish vs +z normal -> direct ~0; ambient*albedo*occ > 0
    assert hdr[:, hit].mean() > 0.01
    assert hdr[:, hit].mean() < 1.0


@pytest.fixture(scope="module")
def full_frame():
    """Every pass enabled (SSR computed AND composited, clouds on) —
    pins per-pass statistics so quirk regressions in the rarely-default
    paths fail loudly."""
    cfg = cfgm.RenderConfig(width=128, height=64, shadow_resolution=128,
                            enable_ssr=True, composite_ssr=True,
                            max_point_lights=1, max_spot_lights=1)
    batch, atlas = build_scene_batch([proc.unit_quad(z=-1.0, size=0.6)],
                                     atlas_size=64)
    plan = fm.FramePlan.create(cfg, atlas, interpret=True)
    plan = dataclasses.replace(
        plan,
        main_grid=dataclasses.replace(plan.main_grid, pair_cap=1024,
                                      med_cap=64),
        shadow_grid=dataclasses.replace(plan.shadow_grid, pair_cap=1024,
                                        med_cap=64))
    cam = Camera3D()
    cam.resize(cfg.width, cfg.height)
    import soc_real_time_renderer.utils.mathutil as mu
    cam.view_mat = mu.look_at([0, 0, 1.0], [0, 0, -1], [0, 1, 0])
    cm = camera_matrices(cam, [0, 0, 1.0], 1, cfg.width, cfg.height)
    g = cfgm.ShaderGlobals.create(camera=cm, camera_prev=cm,
                                  frame_counter=np.int32(1))
    hist = fm.RenderHistory.create(cfg)
    mm = np.eye(4, dtype=np.float32)[None]
    out, hist2 = fm.render_frame(plan, batch, g, hist, mm, mm)
    return out, hist2


def test_full_pipeline_pass_stats(full_frame):
    out, _ = full_frame
    hit = np.asarray(out.gbuffer.depth) < 1.0

    # SSAO: away from edges the flat quad is unoccluded (~1); valid range
    ssao = np.asarray(out.ssao)
    assert np.isfinite(ssao).all()
    assert 0.0 <= ssao.min() and ssao.max() <= 1.0 + 1e-5
    assert ssao.mean() > 0.8

    # SSR exists and is finite; non-metallic quad passes albedo through
    # (screen_space_reflection.inl:169-174)
    ssr = np.asarray(out.ssr)
    assert np.isfinite(ssr).all()
    alb = np.asarray(out.gbuffer.albedo)
    np.testing.assert_allclose(ssr[:, hit], alb[:, hit], atol=5e-2)

    # clouds: sky pixels get atmosphere — blue channel dominates red
    cl = np.asarray(out.clouds)
    assert np.isfinite(cl).all()
    assert cl.shape[1:] == (32, 64)  # half res
    assert cl[2].mean() > cl[0].mean()

    # hdr sky substitution: where depth==1 the hdr equals the upsampled
    # cloud colour (composition.inl:220-222)
    hdr = np.asarray(out.hdr)
    assert np.isfinite(hdr).all()
    assert hdr[:, ~hit].std() > 1e-4  # sky has structure, not a clear

    # bloom target exists and adds energy over raw emissive
    bl = np.asarray(out.bloom)
    assert np.isfinite(bl).all() and bl.min() >= 0.0

    # HiZ pyramids bracket the depth buffer
    d = np.asarray(out.gbuffer.depth)
    assert float(out.hiz_min[-1][0, 0]) == pytest.approx(d.min(), abs=1e-6)
    assert float(out.hiz_max[-1][0, 0]) == pytest.approx(d.max(), abs=1e-6)

    # no raster cap overflow in the tiny scene
    assert int(out.overflow) == 0

    # final colour in range
    color = np.asarray(out.color)
    assert np.isfinite(color).all()
    assert 0.0 <= color.min() and color.max() <= 1.0


def test_history_carry(tiny_frame):
    out, hist2 = tiny_frame
    assert np.isfinite(float(hist2.exposure))
    # previous_color carries the TAA-resolved image (post-TAA != hdr)
    pc = np.asarray(hist2.previous_color)
    assert pc.shape == np.asarray(out.hdr).shape
    assert np.isfinite(pc).all()
    assert np.isfinite(np.asarray(hist2.previous_velocity)).all()
