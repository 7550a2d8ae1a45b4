// Native asset pipeline kernels.
//
// Host-side counterpart of the reference's C++ asset path: stb-style
// image post-processing, GPU-blit mip generation (texture.cpp:190-246)
// and staging-buffer packing (model.cpp:409-465) become host SIMD loops
// feeding one device_put.  Exposed via a plain C ABI for ctypes
// (no pybind11 in the image).
//
// Build: tools/build_native.py (g++ -O3 -march=native -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

extern "C" {

// Bilinear resize RGBA u8 (H, W) -> (OH, OW).
void resize_bilinear_u8(const uint8_t* src, int h, int w,
                        uint8_t* dst, int oh, int ow) {
    for (int y = 0; y < oh; ++y) {
        float fy = (y + 0.5f) * h / oh - 0.5f;
        int y0 = fy < 0 ? 0 : (int)fy;
        if (y0 > h - 1) y0 = h - 1;
        int y1 = y0 + 1 > h - 1 ? h - 1 : y0 + 1;
        float wy = fy - y0;
        if (wy < 0) wy = 0;
        const uint8_t* r0 = src + (size_t)y0 * w * 4;
        const uint8_t* r1 = src + (size_t)y1 * w * 4;
        uint8_t* out = dst + (size_t)y * ow * 4;
        for (int x = 0; x < ow; ++x) {
            float fx = (x + 0.5f) * w / ow - 0.5f;
            int x0 = fx < 0 ? 0 : (int)fx;
            if (x0 > w - 1) x0 = w - 1;
            int x1 = x0 + 1 > w - 1 ? w - 1 : x0 + 1;
            float wx = fx - x0;
            if (wx < 0) wx = 0;
            for (int c = 0; c < 4; ++c) {
                float a = r0[x0 * 4 + c] * (1 - wx) + r0[x1 * 4 + c] * wx;
                float b = r1[x0 * 4 + c] * (1 - wx) + r1[x1 * 4 + c] * wx;
                float v = a * (1 - wy) + b * wy;
                out[x * 4 + c] = (uint8_t)(v + 0.5f);
            }
        }
    }
}

// Full mip chain by 2x2 box reduction on RGBA u8, written as the flat
// [level0 | level1 | ...] texel-major layout (texel index = y*S + x,
// 4 channels each).  dst must hold sum_k (S>>k)^2 * 4 bytes.
void build_mip_chain_u8(const uint8_t* src, int size, uint8_t* dst) {
    size_t off = (size_t)size * size * 4;
    std::memcpy(dst, src, off);
    const uint8_t* prev = dst;
    for (int s = size >> 1; s >= 1; s >>= 1) {
        uint8_t* cur = dst + off;
        int ps = s * 2;
        for (int y = 0; y < s; ++y) {
            const uint8_t* r0 = prev + (size_t)(2 * y) * ps * 4;
            const uint8_t* r1 = prev + (size_t)(2 * y + 1) * ps * 4;
            uint8_t* out = cur + (size_t)y * s * 4;
            for (int x = 0; x < s; ++x) {
                for (int c = 0; c < 4; ++c) {
                    unsigned v = r0[(2 * x) * 4 + c] + r0[(2 * x + 1) * 4 + c]
                               + r1[(2 * x) * 4 + c] + r1[(2 * x + 1) * 4 + c];
                    out[x * 4 + c] = (uint8_t)((v + 2) >> 2);
                }
            }
        }
        prev = cur;
        off += (size_t)s * s * 4;
    }
}

// Transpose a (N, 4) u8 texel block into 4 planar rows of a (16, M)
// atlas (dst_stride = M), writing rows [row0..row0+4).
void scatter_planar_u8(const uint8_t* texels, int64_t n,
                       uint8_t* atlas, int64_t dst_stride,
                       int row0, int64_t col0) {
    for (int c = 0; c < 4; ++c) {
        uint8_t* dst = atlas + (size_t)(row0 + c) * dst_stride + col0;
        const uint8_t* s = texels + c;
        for (int64_t i = 0; i < n; ++i) dst[i] = s[i * 4];
    }
}

// EXR ZIP predictor + interleave (utils/exr.py hot loop).
void exr_unpredict(uint8_t* data, int64_t n) {
    if (n <= 0) return;  // degenerate block: data[0]/tmp[0] would be OOB
    std::vector<uint8_t> tmp(n);
    int acc = data[0];
    tmp[0] = (uint8_t)acc;
    for (int64_t i = 1; i < n; ++i) {
        acc = (acc + data[i] - 128) & 0xff;
        tmp[i] = (uint8_t)acc;
    }
    int64_t half = (n + 1) / 2;
    for (int64_t i = 0; i < half; ++i) data[2 * i] = tmp[i];
    for (int64_t i = half; i < n; ++i) data[2 * (i - half) + 1] = tmp[i];
}

}  // extern "C"
