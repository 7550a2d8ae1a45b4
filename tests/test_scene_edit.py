"""Live scene editing: the viewer's create-entity → add-mesh → render
workflow (scene_hiearchy_panel.cpp context-menu ops + the reference's
load-model-into-new-entity behavior).

Pins the three pieces the HTTP layer composes:
 * panel mutations change the ECS and the mesh signature exactly when
   the renderable set changes;
 * BuiltScene.rebuild() re-packs the batch so the new entity's
   triangles actually enter the frame;
 * a frame renders end-to-end after the rebuild and differs from the
   pre-edit frame.
"""
import dataclasses

import numpy as np

from soc_real_time_renderer import scenes
from soc_real_time_renderer.config import RenderConfig
from soc_real_time_renderer.graph import frame as frame_mod
from soc_real_time_renderer.scene.components import (MeshComponent,
                                                         TransformComponent)
from soc_real_time_renderer.ui.scene_panel import SceneHiearchyPanel

CFG = RenderConfig(width=128, height=128, shadow_resolution=128,
                   enable_ssao=False, enable_bloom=False,
                   enable_clouds=False, enable_taa=False,
                   enable_auto_exposure=False, enable_hiz=False)


def _small_caps(b):
    b.plan = dataclasses.replace(
        b.plan,
        main_grid=dataclasses.replace(b.plan.main_grid,
                                      pair_cap=65536, med_cap=1024),
        shadow_grid=dataclasses.replace(b.plan.shadow_grid,
                                        pair_cap=65536, med_cap=1024),
        interpret=True)
    return b


def _render_one(b):
    render = frame_mod.make_render_fn(b.plan)
    g, mm, nm = b.frame_globals(1)
    out, _ = render(b.batch, g,
                    frame_mod.RenderHistory.create(b.plan.config), mm, nm)
    return np.asarray(out.color)


def test_add_mesh_entity_rebuild_renders():
    built = _small_caps(scenes.build("helmet", CFG))
    panel = SceneHiearchyPanel(built.scene,
                               model_loader=scenes.default_model)
    t0 = built.batch.num_triangles
    sig0 = built.mesh_signature()
    frame0 = _render_one(built)

    eid = panel.create_entity("second helmet")
    panel.select(eid)
    # an entity without a loaded mesh must NOT change the signature
    assert built.mesh_signature() == sig0
    panel.add_component(eid, "TransformComponent")
    panel.set_property(eid, "TransformComponent", "position",
                       [1.2, 0.0, 0.0])
    comp = panel.add_component(eid, "MeshComponent")
    assert comp.model is not None, "model_loader must assign a model"
    assert built.mesh_signature() != sig0

    built.rebuild()
    built = _small_caps(built)          # rebuild resets plan caps
    assert built.batch.num_triangles == 2 * t0
    mm, _ = built.scene.transform_matrices()
    assert mm.shape[0] == 2

    frame1 = _render_one(built)
    assert frame1.shape == frame0.shape
    assert np.abs(frame1 - frame0).max() > 0.01, \
        "added mesh must change the rendered frame"

    # destroy restores the original batch
    panel.destroy_entity(eid)
    assert built.mesh_signature() == sig0
    built.rebuild()
    assert built.batch.num_triangles == t0


def test_components_schema_roundtrip_json():
    import json

    from soc_real_time_renderer.ui.server import _jsonable
    built = _small_caps(scenes.build("helmet", CFG))
    panel = SceneHiearchyPanel(built.scene)
    eid = built.scene.mesh_entities()[0].eid
    panel.select(eid)
    s = json.dumps({"scene": panel.tree(),
                    "components": panel.components_schema(eid)},
                   default=_jsonable)
    back = json.loads(s)
    assert "TransformComponent" in back["components"]
    assert back["components"]["TransformComponent"]["position"][0] == "vec3"


def test_transform_edit_reproves_shadow_elision():
    """Moving geometry into the sun volume via a live transform edit
    must defeat the build-time shadow-elision proof (the cheap rebuild
    path re-proves against the LIVE transforms; previously the stale
    proof silently substituted an all-1.0 shadow map — helmet_lifted's
    exact configuration with no shadow and no error)."""
    built = _small_caps(scenes.build("helmet", CFG))
    panel = SceneHiearchyPanel(built.scene)
    assert built.plan.shadow_statically_empty
    eid = built.scene.mesh_entities()[0].eid
    # y=32 is inside the sun ortho volume (y 24..56) — the lifted case
    panel.set_property(eid, "TransformComponent", "position",
                       [0.0, 32.0, 0.0])
    built.rebuild()
    assert not built.plan.shadow_statically_empty, \
        "live transform into the sun volume must defeat the proof"
    # moving back restores the elision (cheap path both ways: the
    # batch object must be untouched)
    batch0 = built.batch
    panel.set_property(eid, "TransformComponent", "position",
                       [0.0, 0.0, 0.0])
    built.rebuild()
    assert built.plan.shadow_statically_empty
    assert built.batch is batch0, "cheap path must not re-pack the batch"


def test_live_added_light_enters_the_frame():
    """A PointLight added live must widen the statically-bounded
    composition light scan (previously max_point_lights stayed frozen
    at the build-time count and the new light was silently invisible)."""
    built = _small_caps(scenes.build("helmet", CFG))
    panel = SceneHiearchyPanel(built.scene)
    assert built.plan.config.max_point_lights == 0
    frame0 = _render_one(built)

    eid = panel.create_entity("lamp")
    panel.add_component(eid, "TransformComponent")
    panel.set_property(eid, "TransformComponent", "position",
                       [0.0, 0.0, 1.5])
    panel.add_component(eid, "PointLightComponent")
    panel.set_property(eid, "PointLightComponent", "intensity", 40.0)
    built.rebuild()
    built = _small_caps(built)
    assert built.plan.config.max_point_lights == 1
    frame1 = _render_one(built)
    assert np.abs(frame1 - frame0).max() > 0.01, \
        "live-added light must change the rendered frame"


def test_dof_does_not_compound_into_taa_history():
    """With depth-of-field enabled on a static scene, repeated frames
    must converge (TAA) rather than blur monotonically (the old graph
    fed the DoF output back as TAA history, so every frame re-blurred
    the previous blur)."""
    import dataclasses as dc

    cfg = CFG.replace(enable_taa=True, enable_depth_of_field=True)
    built = _small_caps(scenes.build("helmet", cfg))
    render = frame_mod.make_render_fn(built.plan)
    hist = frame_mod.RenderHistory.create(built.plan.config)
    g, mm, nm = built.frame_globals(1)     # one fixed camera/jitter
    frames = []
    for _ in range(8):
        out, hist = render(built.batch, g, hist, mm, nm)
        frames.append(np.asarray(out.color))
    d_early = np.abs(frames[2] - frames[1]).mean()
    d_late = np.abs(frames[7] - frames[6]).mean()
    assert d_late <= d_early + 1e-5, (d_early, d_late)
    # and the long-run drift must be tiny (blur accumulation showed up
    # as a monotonic frame-to-frame delta)
    assert d_late < 2e-3, d_late


def test_rebuild_preserves_plan_overrides():
    """A customized plan (trilinear A/B, interpret mode) must survive a
    full rebuild — previously rebuild() silently reverted to defaults."""
    import dataclasses as dc

    built = _small_caps(scenes.build("helmet", CFG))
    built.plan = dc.replace(built.plan, texture_filter="trilinear")
    panel = SceneHiearchyPanel(built.scene,
                               model_loader=scenes.default_model)
    eid = panel.create_entity("second")
    panel.add_component(eid, "TransformComponent")
    panel.add_component(eid, "MeshComponent")
    built.rebuild()                         # full path (model set grew)
    assert built.plan.texture_filter == "trilinear"
    assert built.plan.interpret is True


def test_rebuild_empty_scene_is_noop():
    built = _small_caps(scenes.build("helmet", CFG))
    panel = SceneHiearchyPanel(built.scene)
    batch0 = built.batch
    for e in list(built.scene.mesh_entities()):
        panel.destroy_entity(e.eid)
    assert built.mesh_signature() == ()
    built.rebuild()                     # no renderable meshes: keep batch
    assert built.batch is batch0


def test_live_sun_edit_reproves_elision():
    """The viewer's sun-position edit (reference ImGui control): moving
    the sun rebuilds its matrices AND re-runs the shadow-elision proof,
    so the frame renders with correct shadows instead of tripping
    check_sun_proof or silently composing against the stale 1.0 map."""
    built = _small_caps(scenes.build("helmet", CFG))
    assert built.plan.shadow_statically_empty
    frame0 = _render_one(built)

    # sun just above the helmet: geometry enters the +-16 ortho volume,
    # the proof must FAIL and the raster path must pay
    built.set_sun(position=(0.0, 8.0, 0.0))
    built.rebuild()
    built = _small_caps(built)          # rebuild resets plan overrides
    assert not built.plan.shadow_statically_empty
    frame1 = _render_one(built)         # guard passes: proof matches sun
    assert np.isfinite(frame1).all()
    assert np.abs(frame1 - frame0).max() > 1e-3  # lighting changed

    # back to the default sun: proof holds again and the guard accepts
    built.set_sun(position=(-3.2, 40.0, -4.0))
    built.rebuild()
    built = _small_caps(built)
    assert built.plan.shadow_statically_empty
    frame2 = _render_one(built)
    np.testing.assert_allclose(frame2, frame0, atol=1e-5)


def test_live_terrain_rebake_changes_model():
    """The viewer's terrain height-scale edit re-bakes the terrain
    model host-side (models/terrain.py docstring promise): the model
    identity changes (routing rebuild onto the full re-pack) and the
    baked displacement actually doubles."""
    from soc_real_time_renderer.scene.components import MeshComponent
    from soc_real_time_renderer.ui.server import _rebake_terrain
    cfg = RenderConfig(width=64, height=64, shadow_resolution=64,
                       enable_clouds=False)
    built = scenes.build("terrain", cfg)
    sig0 = built.mesh_signature()

    def y_range(b):
        for e in b.scene.mesh_entities():
            m = e.get_component(MeshComponent).model
            if m.terrain:
                return float(m.positions[:, 1].max()
                             - m.positions[:, 1].min())
        raise AssertionError("no terrain entity")

    y0 = y_range(built)
    assert _rebake_terrain(built, {"height_scale": 140.0})
    assert built.mesh_signature() != sig0
    assert abs(y_range(built) / y0 - 2.0) < 1e-3  # 70 -> 140 doubles y
    # helmet scenes have no terrain: the re-bake is a no-op
    helmet = scenes.build("helmet", CFG)
    assert not _rebake_terrain(helmet, {"height_scale": 140.0})
