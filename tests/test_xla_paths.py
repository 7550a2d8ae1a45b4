"""The XLA passes that replaced the windowed kernels, against small
numpy references: SSAO, the TAA resolve with its history reprojection,
and the packed-atlas texture tap (bilinear and trilinear).  Plus the
main path's independence from Pillow and the zlib PNG writer."""
import struct
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from soc_real_time_renderer import config as cfg_mod
from soc_real_time_renderer.camera import Camera3D, camera_matrices
from soc_real_time_renderer.models.texture import (PackedMaterialAtlas,
                                                   SAMPLED_ROWS,
                                                   expand_atlas_bilinear)
from soc_real_time_renderer.ops import gbuffer, ssao, taa
from soc_real_time_renderer.utils import mathutil as mu

F = np.float32


def _bilinear_clamp(img, u, v):
    """(C, H, W) sampled at uv in [0,1] with clamp-to-edge (numpy)."""
    C, H, W = img.shape
    x = u * F(W) - F(0.5)
    y = v * F(H) - F(0.5)
    x0 = np.clip(np.floor(x).astype(np.int64), 0, W - 1)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, H - 1)
    fx = np.clip(x - x0, 0, 1).astype(F)
    fy = np.clip(y - y0, 0, 1).astype(F)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    top = img[:, y0, x0] * (1 - fx) + img[:, y0, x1] * fx
    bot = img[:, y1, x0] * (1 - fx) + img[:, y1, x1] * fx
    return (top * (1 - fy) + bot * fy).astype(F)


def _globals(W, H):
    cam = Camera3D()
    cam.resize(W, H)
    cam.view_mat = mu.look_at(np.array([0.0, 1.0, 3.0], F),
                              np.zeros(3, F), np.array([0.0, 1.0, 0.0], F))
    return cfg_mod.ShaderGlobals.create(
        camera=camera_matrices(cam, np.array([0.0, 1.0, 3.0], F), 0, W, H))


def _noise(u, v, freq):
    def rand(cu, cv):
        return np.mod(np.sin(cu * F(12.9898) + cv * F(78.233))
                      * F(43758.5453), F(1.0))
    unit = F(2560.0) / freq
    iu, iv = np.floor(u / unit), np.floor(v / unit)
    xu = np.mod(u, unit) / unit
    xv = np.mod(v, unit) / unit
    xu = F(0.5) * (1 - np.cos(F(np.pi) * xu))
    xv = F(0.5) * (1 - np.cos(F(np.pi) * xv))
    a, b = rand(iu, iv), rand(iu + 1, iv)
    c, d = rand(iu, iv + 1), rand(iu + 1, iv + 1)
    x1 = a + (b - a) * xu
    x2 = c + (d - c) * xu
    return (x1 + (x2 - x1) * xv).astype(F)


def _normalize(a):
    return a / np.maximum(np.sqrt((a * a).sum(0)), F(1e-8))


def ssao_reference(depth, normal, g, K=26):
    """ssao_generation.inl:174-214 in numpy float32, per half-res px."""
    H, W = depth.shape
    h, w = H // 2, W // 2
    u, v = np.meshgrid((np.arange(w, dtype=F) + F(0.5)) / F(w),
                       (np.arange(h, dtype=F) + F(0.5)) / F(h))
    d = _bilinear_clamp(depth[None], u, v)[0]
    n = _bilinear_clamp(normal, u, v)
    ip = np.asarray(g.camera.inv_projection, F)
    ndc = np.stack([u * 2 - 1, v * 2 - 1, d, np.ones_like(d)])
    vp = np.einsum("ij,jhw->ihw", ip, ndc)
    frag = vp[:3] / np.where(vp[3] != 0, vp[3], 1)
    nv = np.einsum("ij,jhw->ihw", np.asarray(g.camera.view, F)[:3, :3],
                   _normalize(n))
    rx = _noise(u, v, F(W * 2.0))
    ry = _noise(u ** F(1.1), v ** F(1.1),
                np.power(F(W * 4.2), F(1.5) + u / F(10)))
    rv = _normalize(np.stack([rx, ry, np.zeros_like(rx)]))
    t = _normalize(rv - nv * (rv * nv).sum(0))
    b = np.stack([t[1] * nv[2] - t[2] * nv[1], t[2] * nv[0] - t[0] * nv[2],
                  t[0] * nv[1] - t[1] * nv[0]])
    proj = np.asarray(g.camera.projection, F)
    radius, bias = F(g.ssao_radius), F(g.ssao_bias)
    occ = np.zeros((h, w), F)
    for k in np.asarray(ssao.KERNEL[:K], F):
        s = frag + (t * k[0] + b * k[1] + nv * k[2]) * radius
        o = np.einsum("ij,jhw->ihw", proj, np.concatenate(
            [s, np.ones((1, h, w), F)]))
        ow = np.where(o[3] != 0, o[3], 1)
        ou = o[0] / ow * F(0.5) + F(0.5)
        ov = o[1] / ow * F(0.5) + F(0.5)
        xi = np.clip((ou * W - F(0.5)).astype(np.int32), 0, W - 1)
        yi = np.clip((ov * H - F(0.5)).astype(np.int32), 0, H - 1)
        sd = depth[yi, xi]
        q = np.stack([ou * 2 - 1, ov * 2 - 1, sd, np.ones_like(sd)])
        vz = np.einsum("j,jhw->hw", ip[2], q)
        vw = np.einsum("j,jhw->hw", ip[3], q)
        sample_z = vz / np.where(vw != 0, vw, 1)
        tt = np.clip(radius / np.maximum(np.abs(frag[2] - sample_z),
                                         F(1e-8)), 0, 1)
        occ += (sample_z >= s[2] + bias) * (tt * tt * (3 - 2 * tt))
    return 1 - occ / F(K)


def _scene_fields(H, W, seed):
    """A tilted floor plus a box face in front of the camera: depth in
    NDC and world normals, smooth with one discontinuity."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(F)
    depth = (F(0.92) + F(0.06) * yy / H).astype(F)
    box = (xx > W * 0.3) & (xx < W * 0.6) & (yy > H * 0.2) & (yy < H * 0.7)
    depth = np.where(box, F(0.9), depth) + rng.uniform(
        0, 1e-4, (H, W)).astype(F)
    normal = np.zeros((3, H, W), F)
    normal[1] = 1
    normal[:, box] = np.array([0, 0, 1], F)[:, None]
    return depth.astype(F), normal


@pytest.mark.parametrize("seed", [0, 1])
def test_ssao_matches_numpy_reference(seed):
    H, W = 48, 64
    depth, normal = _scene_fields(H, W, seed)
    g = _globals(W, H)
    got = np.asarray(ssao.ssao_generate(jnp.asarray(depth),
                                        jnp.asarray(normal), g))
    want = ssao_reference(depth, normal, g)
    assert got.shape == (H // 2, W // 2)
    # float32 on both sides; a tap whose depth compare sits on the
    # threshold may flip, one tap is 1/26
    diff = np.abs(got - want)
    assert diff.mean() < 2e-3, diff.mean()
    assert (diff > 1.0 / 26 + 1e-3).mean() < 0.01
    assert 0.0 < got.min() and got.max() <= 1.0


def taa_reference(color, depth, velocity, prev_c, prev_v, frame_counter):
    """temporal_antialiasing.inl:120-199 in numpy (module docstring of
    ops/taa.py: neighbours[5] quirk, closest-depth dilation, bilinear
    history at uv - velocity, AABB clamp, disocclusion blend)."""
    C, H, W = color.shape

    def shift(img, dx, dy):
        ys = np.clip(np.arange(H) + dy, 0, H - 1)
        xs = np.clip(np.arange(W) + dx, 0, W - 1)
        return img[..., ys, :][..., :, xs]

    gauss = [1 / 16, 1 / 8, 1 / 16, 1 / 8, 1 / 4, 1 / 8, 1 / 16, 1 / 8,
             1 / 16]
    blurred = np.zeros_like(color)
    mn = np.full_like(color, 1e6)
    mx = np.full_like(color, -1e6)
    closest = np.ones_like(depth)
    ddx = np.zeros_like(depth)
    ddy = np.zeros_like(depth)
    center = None
    for y in (1, 0, -1):
        for x in (1, 0, -1):
            idx = (y + 1) * 3 + (x + 1)
            c, d = shift(color, x, y), shift(depth, x, y)
            upd = d <= closest
            closest = np.minimum(closest, d)
            ddx = np.where(upd, x, ddx)
            ddy = np.where(upd, y, ddy)
            mn, mx = np.minimum(mn, c), np.maximum(mx, c)
            blurred = blurred + F(gauss[idx]) * c
            if idx == 5:
                center = c
    vel = np.zeros_like(velocity)
    for y in (1, 0, -1):
        for x in (1, 0, -1):
            m = (ddx == x) & (ddy == y)
            vel = np.where(m[None], shift(velocity, x, y), vel)
    u, v = np.meshgrid((np.arange(W, dtype=F) + F(0.5)) / F(W),
                       (np.arange(H, dtype=F) + F(0.5)) / F(H))
    su, sv = u - vel[0], v - vel[1]
    accum = np.full((H, W), min(0.1, float(frame_counter)), F)
    accum = np.where((su < 0) | (sv < 0) | (su > 1) | (sv > 1), F(1), accum)
    hist = _bilinear_clamp(np.concatenate([prev_c, prev_v]), su, sv)
    acc = np.clip(hist[:3], mn, mx)
    out = center * accum + acc * (1 - accum)
    dv = hist[3:5] - vel
    dis = np.clip((np.sqrt(dv[0] ** 2 + dv[1] ** 2) - F(0.001)) * 10, 0, 1)
    return out + (blurred - out) * dis


@pytest.mark.parametrize("vel_px", [0.0, 2.5, 9.0])
def test_taa_matches_numpy_reference(vel_px):
    H, W = 24, 40
    rng = np.random.default_rng(int(vel_px * 10))
    color = rng.random((3, H, W), dtype=F)
    depth = rng.random((H, W), dtype=F)
    prev_c = rng.random((3, H, W), dtype=F)
    velocity = (rng.uniform(-1, 1, (2, H, W)) * vel_px
                / np.array([W, H], F)[:, None, None]).astype(F)
    prev_v = (velocity + rng.normal(0, 2e-3, (2, H, W))).astype(F)
    got = np.asarray(taa.taa(jnp.asarray(color), jnp.asarray(depth),
                             jnp.asarray(velocity), jnp.asarray(prev_c),
                             jnp.asarray(prev_v), jnp.int32(5)))
    want = taa_reference(color, depth, velocity, prev_c, prev_v, 5)
    np.testing.assert_allclose(got, want, atol=2e-5)


def _toy_atlas(M=3, size=32, seed=0):
    rng = np.random.default_rng(seed)
    n_levels = int(np.log2(size)) + 1
    stride = sum((size >> k) ** 2 for k in range(n_levels))
    packed = rng.integers(0, 256, (16, M * stride), dtype=np.uint8)
    return PackedMaterialAtlas(packed=packed, size=size, num_materials=M,
                               layer_stride=stride, n_levels=n_levels)


def tap_reference(atlas, mid, uv, lod, filter_mode):
    """Wrap-addressed nearest-mip bilinear (or two-mip trilinear) tap of
    the raw (16, N) u8 atlas rows in SAMPLED_ROWS order (numpy)."""
    S, L = atlas.size, atlas.n_levels
    rows = atlas.packed[list(SAMPLED_ROWS)].astype(np.float64)
    uvw = uv - np.floor(uv)

    def level(lv):
        s = S >> lv
        off = (4 * S * S - 4 * s * s) // 3
        x = uvw[0] * s - 0.5
        y = uvw[1] * s - 0.5
        x0, y0 = np.floor(x), np.floor(y)
        fx, fy = x - x0, y - y0
        x0 = x0.astype(np.int64)
        y0 = y0.astype(np.int64)

        def tex(xi, yi):
            return rows[:, mid * atlas.layer_stride + off
                        + np.mod(yi, s) * s + np.mod(xi, s)]
        return ((tex(x0, y0) * (1 - fx) + tex(x0 + 1, y0) * fx) * (1 - fy)
                + (tex(x0, y0 + 1) * (1 - fx)
                   + tex(x0 + 1, y0 + 1) * fx) * fy) / 255.0

    lod = np.clip(lod, 0, L - 1)
    if filter_mode == "bilinear":
        return level(np.round(lod).astype(np.int64))
    l0 = np.floor(lod).astype(np.int64)
    l1 = np.minimum(l0 + 1, L - 1)
    f = lod - l0
    return level(l0) * (1 - f) + level(l1) * f


@pytest.mark.parametrize("filter_mode", ["bilinear", "trilinear"])
def test_texture_tap_matches_numpy_reference(filter_mode):
    atlas = _toy_atlas()
    rng = np.random.default_rng(3)
    P = 2000
    mid = rng.integers(0, atlas.num_materials, P).astype(np.int32)
    uv = rng.uniform(-2.0, 3.0, (2, P)).astype(F)        # exercises wrap
    lod = rng.uniform(-0.5, atlas.n_levels + 0.5, P).astype(F)
    # per-level round/floor decisions at exact half-integers would be
    # rounding-mode artefacts, not tap behaviour: stay off them
    lod = np.where(np.abs(lod - np.round(lod)) < 1e-3, lod + 0.01, lod)
    got = np.asarray(gbuffer.sample_packed_atlas(
        jnp.asarray(expand_atlas_bilinear(atlas)), jnp.asarray(mid),
        jnp.asarray(uv), jnp.asarray(lod), size=atlas.size,
        layer_stride=atlas.layer_stride, n_levels=atlas.n_levels,
        filter_mode=filter_mode))
    want = tap_reference(atlas, mid, uv.astype(np.float64),
                         lod.astype(np.float64), filter_mode)
    assert got.shape == (len(SAMPLED_ROWS), P)
    # f32 texel coordinates: a weight moves by ~1e-4 of a texel at most
    np.testing.assert_allclose(got, want, atol=2e-3)
    assert np.abs(got - want).mean() < 1e-4


def _block_pil(monkeypatch):
    for name in [m for m in sys.modules if m == "PIL" or
                 m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)


def test_terrain_model_and_atlas_without_pillow(monkeypatch):
    from soc_real_time_renderer.models import scene_batch, terrain
    _block_pil(monkeypatch)
    with pytest.raises(ImportError):
        import PIL  # noqa: F401
    hm = terrain.procedural_heightmap(64)
    model = terrain.build_terrain_model(hm, terrain.default_albedo(hm),
                                        tess_level=1)
    assert all(isinstance(im.data, np.ndarray) for im in model.images)
    batch, atlas = scene_batch.build_scene_batch([model], atlas_size=64)
    assert atlas.num_materials == 1
    assert batch.atlas_packed.shape == (atlas.layer_stride, 12)
    # the albedo layer carries the procedural colours, not the white
    # fallback a failed decode would leave
    assert atlas.packed[0:3].std() > 1.0


def test_decoding_a_file_without_pillow_names_the_package(monkeypatch):
    from soc_real_time_renderer.models import texture
    _block_pil(monkeypatch)
    with pytest.raises(ImportError, match="Pillow"):
        texture.decode_image(b"\x89PNG not really")
    arr = np.zeros((4, 4, 4), np.uint8)
    assert texture.decode_image(arr) is arr


def _png_decode(data):
    """Minimal PNG reader for 8-bit RGB/RGBA, filter type 0 (zlib)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            c = {2: 3, 6: 4}[ctype]
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, c)


@pytest.mark.parametrize("channels", [3, 4])
def test_png_writer_round_trips(tmp_path, channels):
    from soc_real_time_renderer.utils import image_io
    img = np.random.default_rng(channels).integers(
        0, 256, (7, 11, channels), dtype=np.uint8)
    path = tmp_path / "f.png"
    image_io.save_png(str(path), img, already_u8=True)
    np.testing.assert_array_equal(_png_decode(path.read_bytes()), img)


def test_cloud_noise_hash_is_an_exact_integer_hash():
    """The procedural cloud noise hash is integer arithmetic, so every
    backend gives the same bits (numpy uint32 reproduces it exactly),
    and its values are uniform on [0, 1)."""
    from soc_real_time_renderer.ops import clouds
    x = np.arange(-300, 120000, 37).astype(F)
    y = (x * F(-0.75)).astype(F)

    def u32(v):
        return v.astype(np.int32).astype(np.uint32)

    with np.errstate(over="ignore"):
        h = u32(x) * np.uint32(0x27D4EB2D) ^ u32(y) * np.uint32(0x165667B1)
        h = (h ^ (h >> 15)) * np.uint32(0x2C1B3C6D)
        h = (h ^ (h >> 12)) * np.uint32(0x297A2D39)
    h = h ^ (h >> 15)
    want = (h >> 8).astype(F) * F(1.0 / 16777216.0)
    got = np.asarray(clouds._hash2(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_array_equal(got, want)
    assert 0.0 <= got.min() and got.max() < 1.0
    assert abs(got.mean() - 0.5) < 0.01 and abs(got.std() - 0.2887) < 0.01
