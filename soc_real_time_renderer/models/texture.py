"""Texture pipeline: decode -> linearize -> mip chain -> packed atlas.

Replacement for the reference's per-texture Vulkan images + samplers
(``src/graphics/texture.{hpp,cpp}``):

* PNG/JPG decode forced to 4 channels (stb-equivalent,
  ``texture.cpp:421-428``) via Pillow, imported only when a file is
  decoded; EXR via :mod:`..utils.exr`; procedural images arrive as
  arrays.
* sRGB images are linearized at load (the reference picks
  ``R8G8B8A8_SRGB`` formats so the hardware sampler linearizes,
  ``model.cpp:52-72``); we pre-linearize into bf16 — same math, done
  once on the host instead of per-sample.
* Full mip chains built by successive 2x2 box reduction — the
  host-side analog of the reference's GPU blit mip generation
  (``texture.cpp:190-246``).
* All material textures of a scene are packed into ONE flat
  ``(N, 4)`` array laid out [layer][level][row][col]: a single gather
  serves any (layer, uv, lod) triple — the answer here to bindless
  per-material samplers.  Every texture is resampled to one
  atlas resolution (default 1024², native for Sponza; DamagedHelmet's
  2048² maps are minified one step).

Because texture decode is host-bound, :func:`decode_images_parallel`
fans decoding out over a thread pool, mirroring the reference's
ThreadPool texture loading (``model.cpp:74-186``).
"""
from __future__ import annotations

import concurrent.futures
import io
from dataclasses import dataclass

import numpy as np

try:  # bf16 numpy dtype ships with jax
    import ml_dtypes
    BF16 = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover
    BF16 = np.dtype(np.float32)


def decode_image(data) -> np.ndarray:
    """Encoded bytes -> (H, W, 4) uint8 (RGBA, like stb's forced 4ch).

    An already decoded (H, W, 4) uint8 array passes through, so
    procedural images never touch an image codec.  Pillow is needed
    only for real image files and is imported here, on first use."""
    if isinstance(data, np.ndarray):
        assert data.dtype == np.uint8 and data.ndim == 3 \
            and data.shape[2] == 4, (data.dtype, data.shape)
        return data
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "decoding png/jpg texture files needs Pillow; procedural "
            "scenes (terrain, atrium without textures) do not") from e
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"), dtype=np.uint8)


def decode_images_parallel(blobs: list[bytes], workers: int = 8
                           ) -> list[np.ndarray]:
    """ThreadPool fan-out decode (model.cpp:74-176 analog)."""
    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        return list(ex.map(decode_image, blobs))


def linear_to_srgb(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.0031308, x * 12.92,
                    1.055 * x ** (1 / 2.4) - 0.055).astype(np.float32)


def resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Separable bilinear resize of (H, W, C) float32 (host, numpy)."""
    H, W = img.shape[:2]
    if (H, W) == (h, w):
        return img
    ys = (np.arange(h) + 0.5) * H / h - 0.5
    xs = (np.arange(w) + 0.5) * W / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    a = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    b = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return (a * (1 - fy) + b * fy).astype(np.float32)


def build_mips(img: np.ndarray) -> list[np.ndarray]:
    """Full mip chain by 2x2 box filter down to 1x1 (texture.cpp:190-246
    blit-chain equivalent). img: (S, S, C) float32, S a power of two."""
    levels = [img]
    while levels[-1].shape[0] > 1:
        cur = levels[-1]
        s = cur.shape[0] // 2
        levels.append(cur.reshape(s, 2, s, 2, -1).mean(axis=(1, 3)))
    return levels


# ---------------------------------------------------------------------------
# Packed per-material atlas (the production path: one gather per tap
# fetches ALL four material textures)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PackedMaterialAtlas:
    """(16, N) uint8: rows 0-3 albedo RGBA (sRGB-encoded), 4-7 normal,
    8-11 metallic-roughness, 12-15 emissive (sRGB-encoded).  Each
    material owns one mip-packed texel space of ``layer_stride`` texels;
    texel (mid, level, y, x) is at
    ``mid * layer_stride + level_off(level) + y * (S >> level) + x``
    with the arithmetic level offset
    ``level_off(l) = (4 S² − 4 (S >> l)²) / 3``.
    """
    packed: np.ndarray          # (16, M * layer_stride) uint8
    size: int
    num_materials: int
    layer_stride: int
    n_levels: int


def _mip_stack_u8(img_u8, size):
    """(H, W, 4) uint8 -> flat (layer_stride, 4) u8 of all mips.

    Uses the native C++ pipeline (utils/native.py) when available; mips
    are box-filtered in the stored (possibly sRGB-encoded) space — a
    small deviation from the reference's linear-space SRGB blits.
    """
    from ..utils import native
    base = native.resize_bilinear_u8(np.ascontiguousarray(img_u8),
                                     size, size)
    return native.build_mip_chain_u8(base)


def pack_material_atlas(materials, images_u8, size: int = 1024,
                        workers: int = 8) -> PackedMaterialAtlas:
    """materials: list of gltf.MaterialData; images_u8: list of decoded
    (H, W, 4) uint8 (raw, sRGB-encoded where applicable).

    Albedo/emissive are stored sRGB-encoded and decoded AFTER filtering
    (a small, standard deviation from filtering-in-linear; the u8 atlas
    halves memory and keeps dark-tone precision).
    """
    n_levels = int(np.log2(size)) + 1
    layer_stride = sum((size >> k) * (size >> k) for k in range(n_levels))
    M = max(len(materials), 1)
    packed = np.zeros((16, M * layer_stride), np.uint8)

    flat_white = np.full((layer_stride, 4), 255, np.uint8)
    flat_normal = np.tile(np.array([128, 128, 255, 255], np.uint8),
                          (layer_stride, 1))
    flat_zero = np.zeros((layer_stride, 4), np.uint8)

    # per-image memo: materials commonly share images across slots and
    # across materials (Sponza-style assets) — the 1024x1024 resize +
    # full mip chain is built once per distinct image, not per use
    _stack_cache: dict[int, np.ndarray] = {}
    _cache_lock = __import__("threading").Lock()

    def mips_of(img_idx, fallback):
        if img_idx < 0 or img_idx >= len(images_u8):
            return fallback
        with _cache_lock:
            hit = _stack_cache.get(img_idx)
        if hit is not None:
            return hit
        # u8 straight through: the old u8->f32->u8 round trip cost a
        # full-res float temp per texture on the scene-load path
        st = _mip_stack_u8(images_u8[img_idx], size)
        with _cache_lock:
            _stack_cache[img_idx] = st
        return st

    import concurrent.futures

    def build_one(mi_m):
        mi, m = mi_m
        s = mi * layer_stride
        packed[0:4, s:s + layer_stride] = mips_of(m.albedo_image,
                                                  flat_white).T
        packed[4:8, s:s + layer_stride] = mips_of(m.normal_image,
                                                  flat_normal).T
        packed[8:12, s:s + layer_stride] = mips_of(
            m.metallic_roughness_image, flat_zero).T
        packed[12:16, s:s + layer_stride] = mips_of(m.emissive_image,
                                                    flat_zero).T

    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        list(ex.map(build_one, enumerate(materials)))

    return PackedMaterialAtlas(packed=packed, size=size, num_materials=M,
                               layer_stride=layer_stride, n_levels=n_levels)


# rows of the packed (16, N) atlas that shading actually reads
# (g_buffer_generation.inl: albedo.rgb :194, normal.rgb :198-213,
# metallic-roughness .g/.b :219-224, emissive.rgb :194): the device
# table drops the 5 never-read channels per corner.
SAMPLED_ROWS = (0, 1, 2,    # albedo RGB
                4, 5, 6,    # normal RGB
                9, 10,      # metallic-roughness G, B
                12, 13, 14)  # emissive RGB
N_SAMPLED = len(SAMPLED_ROWS)


def expand_atlas_bilinear(atlas: PackedMaterialAtlas) -> np.ndarray:
    """(16, N) packed atlas -> (N, 12) int32 ROW-MAJOR device table:
    each texel's row packs the 11 sampled channels (SAMPLED_ROWS) x the
    four bilinear corners as u32 lanes
    ``c00 | c10 << 8 | c01 << 16 | c11 << 24`` (lane 11 = pad), so a
    full bilinear material tap is ONE gather whose 48 bytes are
    CONTIGUOUS in memory (a column-major (44, N) u8 layout would pay
    44 scattered row fetches per index).  The wrap neighbour of every
    texel is a static function of its (level, y, x), so the expansion
    is exact and done once at pack time.
    """
    import sys
    size, n_levels = atlas.size, atlas.n_levels
    stride, M = atlas.layer_stride, atlas.num_materials
    mx = np.empty(stride, np.int32)
    my = np.empty(stride, np.int32)
    mxy = np.empty(stride, np.int32)
    off = 0
    for level in range(n_levels):
        s = size >> level
        y, x = np.mgrid[0:s, 0:s]
        x1 = (x + 1) % s
        y1 = (y + 1) % s
        sl = slice(off, off + s * s)
        mx[sl] = off + (y * s + x1).ravel()
        my[sl] = off + (y1 * s + x).ravel()
        mxy[sl] = off + (y1 * s + x1).ravel()
        off += s * s
    p = atlas.packed[list(SAMPLED_ROWS)]            # (11, N) u8
    N = M * stride
    out = np.zeros((N, 12), np.int32)
    if sys.byteorder == "little":
        # The u32 corner word is just 4 little-endian BYTES
        # [c00, c10, c01, c11]: write them through a u8 view instead of
        # materializing four (11, N) u32 temporaries (~2 GB of
        # allocation churn at Sponza scale; 14 s -> ~1.5 s build time).
        # The wrap indices repeat per material, so each corner gathers
        # through the (M, stride)-reshaped row with the stride-length
        # index — no N-length index array is ever built.
        ob = out.view(np.uint8).reshape(N, 48)
        for r in range(N_SAMPLED):
            q = p[r].reshape(M, stride)
            ob[:, 4 * r + 0] = p[r]
            ob[:, 4 * r + 1] = q[:, mx].ravel()
            ob[:, 4 * r + 2] = q[:, my].ravel()
            ob[:, 4 * r + 3] = q[:, mxy].ravel()
        return out
    base = np.arange(M, dtype=np.int64)[:, None] * stride
    c00 = p.astype(np.uint32)
    c10 = p[:, (base + mx[None, :].astype(np.int64)).ravel()].astype(np.uint32)
    c01 = p[:, (base + my[None, :].astype(np.int64)).ravel()].astype(np.uint32)
    c11 = p[:, (base + mxy[None, :].astype(np.int64)).ravel()].astype(np.uint32)
    packed = (c00 | (c10 << 8) | (c01 << 16) | (c11 << 24))  # (11, N)
    out[:, :11] = packed.astype(np.int32).T
    return out


