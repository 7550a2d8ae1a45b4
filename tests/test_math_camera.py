"""Tests for core math, camera, config defaults, jitter sequence."""
import numpy as np
import pytest

from soc_real_time_renderer import config as cfg
from soc_real_time_renderer.camera import (Camera3D, ControlledCamera3D,
                                               InputState, camera_matrices)
from soc_real_time_renderer.utils import mathutil as mu


def test_perspective_depth_range():
    p = mu.perspective(90.0, 16 / 9, 0.1, 1000.0)
    # near plane -> z_ndc 0, far plane -> z_ndc 1 (Vulkan ZO).
    for z_view, expect in [(-0.1, 0.0), (-1000.0, 1.0)]:
        clip = p @ np.array([0, 0, z_view, 1.0], np.float32)
        assert clip[3] == pytest.approx(-z_view)
        assert clip[2] / clip[3] == pytest.approx(expect, abs=1e-5)


def test_perspective_y_flip():
    # World-up point in front of camera must land at negative NDC y ->
    # *upper* part of image under y-down raster convention.
    p = mu.perspective(90.0, 1.0, 0.1, 100.0)
    v = mu.look_at([0, 0, 0], [0, 0, -1], [0, 1, 0])
    clip = p @ v @ np.array([0.0, 0.5, -1.0, 1.0], np.float32)
    assert clip[1] / clip[3] < 0


def test_look_at_matches_inverse():
    v = mu.look_at([1, 2, 3], [0, 0, 0], [0, 1, 0])
    eye = np.linalg.inv(v) @ np.array([0, 0, 0, 1.0])
    np.testing.assert_allclose(eye[:3], [1, 2, 3], atol=1e-5)


def test_orthographic_unit_cube():
    o = mu.orthographic(-16, 16, -16, 16, -16, 16)
    # RH_ZO: z_view = -near -> 0, z_view = -far -> 1 (near=-16, far=16).
    lo = o @ np.array([-16, -16, 16, 1.0], np.float32)
    hi = o @ np.array([16, 16, -16, 1.0], np.float32)
    np.testing.assert_allclose(lo[:3], [-1, -1, 0], atol=1e-6)
    np.testing.assert_allclose(hi[:3], [1, 1, 1], atol=1e-6)


def test_trs_compose():
    m = mu.compose_trs([1, 2, 3], [0, 90, 0], [2, 2, 2])
    # +x axis rotated by yaw 90deg (glm): x -> -z... check a known point
    p = m @ np.array([1, 0, 0, 1], np.float32)
    assert p[1] == pytest.approx(2.0)
    np.testing.assert_allclose(m[:3, 3], [1, 2, 3])
    # orthogonal * scale: column norms = 2
    np.testing.assert_allclose(np.linalg.norm(m[:3, :3], axis=0), 2.0,
                               rtol=1e-6)


def test_normal_matrix_inverse_transpose():
    m = mu.compose_trs([0, 0, 0], [10, 20, 30], [1, 2, 3])
    n = mu.normal_matrix(m)
    np.testing.assert_allclose(n[:3, :3], np.linalg.inv(m[:3, :3]).T,
                               atol=1e-5)


def test_plastic_jitter_sequence():
    # application.cpp:113-127: values in [-0.5, 0.5] / resolution, cycle 32.
    j1 = np.asarray(cfg.plastic_jitter(0, 100, 100))
    j33 = np.asarray(cfg.plastic_jitter(32, 100, 100))
    np.testing.assert_allclose(j1, j33, atol=1e-7)
    g = 1.32471795724474602596
    expect_x = (0.5 + (1 / g) * 1.0) % 1.0 - 0.5
    assert j1[0] == pytest.approx(expect_x / 100, abs=1e-6)
    js = np.stack([np.asarray(cfg.plastic_jitter(i, 1, 1)) for i in range(32)])
    assert np.all(np.abs(js) <= 0.5)
    assert len(np.unique(np.round(js[:, 0], 6))) == 32  # low discrepancy


def test_controlled_camera_moves_forward():
    c = ControlledCamera3D()
    c.camera.resize(1280, 720)
    c.update(InputState(forward=True), dt=0.1)
    # rotation 0 -> forward = (+1, 0, 0)
    assert c.position[0] > 0
    np.testing.assert_allclose(c.position[1:], 0, atol=1e-6)


def test_controlled_camera_pitch_clamp():
    c = ControlledCamera3D()
    c.update(InputState(cursor_dy=1e9), dt=0.1)
    assert c.rotation[1] == pytest.approx(1.56825555556)


def test_camera_matrices_jitter_applied():
    cam = Camera3D()
    cam.resize(640, 360)
    cm = camera_matrices(cam, [0, 0, 0], jitter_index=3, width=640, height=360)
    base = camera_matrices(cam, [0, 0, 0], jitter_index=None, width=640,
                           height=360)
    d = np.asarray(cm.projection) - np.asarray(base.projection)
    assert d[0, 3] != 0 and d[1, 3] != 0
    np.testing.assert_allclose(d[0, 3], np.asarray(cm.jitter)[0])
    # inverse consistency
    np.testing.assert_allclose(
        np.asarray(cm.projection) @ np.asarray(cm.inv_projection), np.eye(4),
        atol=1e-4)


def test_sun_info_defaults():
    s = cfg.SunInfo.create()
    # direction = (0,-1,0) rotated 4deg about X (renderer.cpp:113-117)
    np.testing.assert_allclose(
        np.asarray(s.direction),
        [0.0, -np.cos(np.radians(4.0)), -np.sin(np.radians(4.0))], atol=1e-6)
    assert float(s.exponential_factor) == -80.0
    assert float(s.bias) == pytest.approx(1e-4)


def test_shader_globals_defaults_pytree():
    import jax
    g = cfg.ShaderGlobals.create()
    assert float(g.ambient_occlussion_strength) == pytest.approx(1.2)
    assert float(g.target_luminance) == pytest.approx(0.2140)
    # renderer.cpp:100-102 double remap
    assert float(g.log_min_luminance) == pytest.approx(
        np.log2(0.2140 / 2**-15.0))
    leaves = jax.tree_util.tree_leaves(g)
    assert len(leaves) > 40
    # roundtrips through tree flatten/unflatten
    flat, treedef = jax.tree_util.tree_flatten(g)
    g2 = jax.tree_util.tree_unflatten(treedef, flat)
    assert float(g2.peak) == 1.0
