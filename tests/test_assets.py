"""Asset pipeline tests: glTF, textures/atlas, EXR, terrain, scene batch."""
import numpy as np
import jax.numpy as jnp
import pytest

from soc_real_time_renderer.models import gltf, proc, terrain, texture
from soc_real_time_renderer.models.scene_batch import (
    build_scene_batch, split_large_triangles)
from soc_real_time_renderer.utils import exr

HELMET = "/root/reference/assets/DamagedHelmet/glTF/DamagedHelmet.gltf"
HELMET_GLB = "/root/reference/assets/DamagedHelmet/glTF-Binary/DamagedHelmet.glb"


def test_gltf_and_glb_agree():
    a = gltf.load_model(HELMET)
    b = gltf.load_model(HELMET_GLB)
    assert len(a.triangles) == len(b.triangles) == 15452
    np.testing.assert_allclose(a.positions, b.positions, atol=1e-6)
    assert len(a.images) == len(b.images) == 5
    assert a.materials[0].albedo_image >= 0
    assert a.images[a.materials[0].albedo_image].srgb
    assert not a.images[a.materials[0].normal_image].srgb


def test_gltf_missing_file_raises():
    with pytest.raises(FileNotFoundError):
        gltf.load_model("/nonexistent/model.gltf")


def test_node_transform_flag():
    # helmet node carries a +90deg X rotation; reference ignores it
    raw = gltf.load_model(HELMET, apply_node_transforms=False)
    xf = gltf.load_model(HELMET, apply_node_transforms=True)
    assert not np.allclose(raw.positions, xf.positions)
    # rotation about X: y' = -z, z' = y
    np.testing.assert_allclose(xf.positions[:, 1], -raw.positions[:, 2],
                               atol=1e-3)


def test_exr_roundtrip_compressed_and_raw():
    rng = np.random.default_rng(0)
    img = rng.random((3, 33, 47)).astype(np.float32) * 10.0
    for compress in (True, False):
        exr.write_exr("/tmp/_t.exr", img, compress=compress)
        out, names = exr.read_exr("/tmp/_t.exr")
        order = [names.index(c) for c in ("R", "G", "B")]
        np.testing.assert_allclose(out[order], img, atol=1e-6)


def test_exr_rgba_mapping():
    img = np.random.default_rng(1).random((1, 8, 8)).astype(np.float32)
    exr.write_exr("/tmp/_t1.exr", img)
    rgba = exr.read_exr_rgba("/tmp/_t1.exr")
    assert rgba.shape == (8, 8, 4)
    np.testing.assert_allclose(rgba[..., 3], 1.0)


def test_pack_material_atlas_layout():
    img = (np.random.default_rng(2).random((64, 64, 4)) * 255).astype(np.uint8)
    mats = [gltf.MaterialData(albedo_image=0)]
    atlas = texture.pack_material_atlas(mats, [img], size=64)
    assert atlas.packed.shape == (16, atlas.layer_stride)
    assert atlas.n_levels == 7
    # level offsets arithmetic: off(l) = (4S^2 - 4(S>>l)^2)/3
    for lvl in range(7):
        s = 64 >> lvl
        off = (4 * 64 * 64 - 4 * s * s) // 3
        assert off < atlas.layer_stride or s == 0
    # missing normal map -> flat normal (128,128,255)
    off1 = (4 * 64 * 64 - 4 * 32 * 32) // 3
    assert atlas.packed[4, 0] == 128 and atlas.packed[6, 0] == 255


def test_height_to_normal_flat_and_slope():
    flat = np.full((16, 16), 0.5, np.float32)
    n = terrain.height_to_normal(flat)
    np.testing.assert_allclose(np.abs(n[..., 1]), 1.0, atol=1e-5)
    ramp = np.linspace(0, 1, 16, dtype=np.float32)[None, :].repeat(16, 0)
    n2 = terrain.height_to_normal(ramp)
    assert np.abs(n2[4:-4, 4:-4, 0]).mean() > 0.1  # tilted in x


def test_terrain_model_build():
    hm = terrain.procedural_heightmap(64)
    alb = terrain.default_albedo(hm)
    m = terrain.build_terrain_model(hm, alb, tess_level=1)
    assert m.terrain
    assert len(m.triangles) == 99 * 99 * 2
    assert m.positions[:, 1].max() <= (1.0 - 0.2) * 70.0 + 1e-3


def test_scene_batch_planar_layout():
    quad = proc.unit_quad()
    batch, atlas = build_scene_batch([quad], atlas_size=64)
    T = batch.num_triangles
    assert batch.tri_pos.shape == (3, 3, T)
    assert batch.tri_uv.shape == (3, 2, T)
    assert batch.static_rows.shape == (5, T)
    # row-major u32-packed bilinear table (texture.expand_atlas_bilinear)
    assert batch.atlas_packed.shape[1] == 12
    assert batch.atlas_packed.dtype == jnp.int32


def test_split_large_triangles():
    pos = np.array([[[0, 0, 0], [10, 0, 0], [0, 10, 0]]], np.float32)
    nrm = np.zeros_like(pos)
    uv = np.zeros((1, 3, 2), np.float32)
    ent = np.zeros(1, np.int32)
    mat = np.zeros((1, 2), np.float32)
    p2, n2, u2, e2, m2 = split_large_triangles(pos, nrm, uv, ent, mat, 6.0)
    assert len(p2) > 1
    ext = (p2.max(axis=1) - p2.min(axis=1)).max(axis=-1)
    assert ext.max() <= 6.0 + 1e-5


def test_atrium_scale():
    m = proc.build_atrium(texture_dir=None)
    assert len(m.triangles) > 20_000
    assert len(m.materials) == 5


def test_expand_atlas_bilinear_paths_agree():
    """The little-endian byte-view fast path of expand_atlas_bilinear
    must be bit-identical to the generic u32-shift path (the fast path
    writes the 4 bilinear corners as raw little-endian bytes)."""
    import sys
    import unittest.mock as mock

    from soc_real_time_renderer.models import texture as tx

    rng = np.random.default_rng(3)
    size = 16
    n_levels = int(np.log2(size)) + 1
    stride = sum((size >> k) ** 2 for k in range(n_levels))
    M = 3
    at = tx.PackedMaterialAtlas(
        packed=rng.integers(0, 256, (16, M * stride), dtype=np.uint8),
        size=size, num_materials=M, layer_stride=stride,
        n_levels=n_levels)
    fast = tx.expand_atlas_bilinear(at)
    with mock.patch.object(sys, "byteorder", "big"):
        generic = tx.expand_atlas_bilinear(at)
    np.testing.assert_array_equal(fast, generic)


def test_subdivide_quad_grid():
    """subdivide_quad covers the quad exactly in j-major cell order
    with shared grid corners (the vectorized rewrite keeps the old
    per-cell loop's ordering)."""
    q = proc.subdivide_quad([0, 0, 0], [2, 0, 0], [2, 3, 0], [0, 3, 0],
                            4, 3)
    assert q.shape == (12, 4, 3)
    # cell (i=1, j=2) -> index j*nx+i = 9; corners at u=[.25,.5], v=[2/3,1]
    np.testing.assert_allclose(
        q[9], [[0.5, 2.0, 0.0], [1.0, 2.0, 0.0],
               [1.0, 3.0, 0.0], [0.5, 3.0, 0.0]], atol=1e-6)
