"""Resize path (SURVEY §3.5: window resize -> swapchain.resize +
recreate_framebuffer + camera.resize, renderer.cpp:815-881,
application.cpp:96-100).

BuiltScene.resize recreates the resolution-dependent state in place;
a resized scene must render EXACTLY what a fresh build at the target
resolution renders (the reference's task graph is not rebuilt on
resize — persistent TaskImages just swap backing images)."""
import numpy as np
import pytest

from soc_real_time_renderer import scenes
from soc_real_time_renderer.config import RenderConfig
from soc_real_time_renderer.graph import frame as fm
from soc_real_time_renderer.models import proc
from soc_real_time_renderer.scene.components import (MeshComponent,
                                                         TransformComponent)
from soc_real_time_renderer.scene.scene import Scene


def _tiny_built(w, h):
    cfg = RenderConfig(width=w, height=h, shadow_resolution=128,
                       enable_clouds=False)
    scene = Scene("resize")
    e = scene.create_entity("quad")
    e.add_component(TransformComponent())
    mc = e.add_component(MeshComponent())
    mc.model = proc.unit_quad(z=-1.0, size=0.6)
    return scenes._finish(scene, [mc.model], cfg,
                          camera_pos=[0.0, 0.0, 1.0],
                          camera_target=[0.0, 0.0, -1.0])


def _render(built, frame_index=1):
    g, mm, nm = built.frame_globals(frame_index)
    hist = fm.RenderHistory.create(built.plan.config)
    out, _ = fm.render_frame(built.plan, built.batch, g, hist, mm, nm)
    return np.asarray(out.color)


def test_resize_matches_fresh_build():
    built = _tiny_built(128, 64)
    before = _render(built)
    assert before.shape == (3, 64, 128)

    built.resize(192, 96)
    assert built.plan.config.width == 192
    assert built.plan.config.height == 96
    # camera aspect follows the new window (application.cpp:98)
    assert abs(built.camera.aspect - 2.0) < 1e-6
    after = _render(built)
    assert after.shape == (3, 96, 192)

    fresh = _render(_tiny_built(192, 96))
    np.testing.assert_array_equal(after, fresh)


def test_resize_keeps_scene_and_shadow_state():
    built = _tiny_built(128, 64)
    batch0 = built.batch
    plan0 = built.plan
    built.resize(192, 96)
    # geometry/atlas untouched (no re-pack, no re-upload)
    assert built.batch is batch0
    # shadow grid + elision proof are resolution-independent
    assert built.plan.shadow_grid == plan0.shadow_grid
    assert (built.plan.shadow_statically_empty
            == plan0.shadow_statically_empty)
    assert built.plan.proved_sun_pv == plan0.proved_sun_pv


@pytest.mark.parametrize("w,h", [(100, 64), (128, 60), (32, 32), (0, 128)])
def test_resize_rejects_unaligned(w, h):
    built = _tiny_built(128, 64)
    with pytest.raises(ValueError):
        built.resize(w, h)
