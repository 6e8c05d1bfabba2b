// rdt_native — host-side C++ runtime for raymarchdenoiser.
//
// Counterpart of the reference's C++ host runtime
// (include/vector.h transfer paths, src/image.cpp conversions): the uint8
// interleaved <-> planar float32 conversions that sit on the host->device
// boundary, plus an independent CPU implementation of the reference filter
// *semantics* (src/filter.cu:13-158) used as the golden oracle in parity
// tests.  Written from the behavioral spec in SURVEY.md §2 (C1/C2), not
// translated from the CUDA source.
//
// Build: python3 native/build.py   ->   native/librdt_native.so

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

extern "C" {

// Interleaved uint8 (H, W, C) -> planar float32 (C, H, W) in [0, 1].
void rdt_u8_to_planar_f32(const uint8_t* in, float* out, int h, int w, int c) {
    const float inv = 1.0f / 255.0f;
    for (int ch = 0; ch < c; ++ch) {
        float* dst = out + (size_t)ch * h * w;
        const uint8_t* src = in + ch;
        const size_t n = (size_t)h * w;
        for (size_t i = 0; i < n; ++i) dst[i] = (float)src[i * c] * inv;
    }
}

// Planar float32 (C, H, W) in [0, 1] -> interleaved uint8 (H, W, C),
// round-half-away with clipping.
void rdt_planar_f32_to_u8(const float* in, uint8_t* out, int h, int w, int c) {
    const size_t n = (size_t)h * w;
    for (int ch = 0; ch < c; ++ch) {
        const float* src = in + (size_t)ch * n;
        uint8_t* dst = out + ch;
        for (size_t i = 0; i < n; ++i) {
            float v = src[i];
            v = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
            dst[i * c] = (uint8_t)(v * 255.0f + 0.5f);
        }
    }
}

// Iterated uniform-average filter over interleaved uint8 RGB with the exact
// reference semantics: per level, float accumulate over in-range taps of a
// (2*radius+1)^2 window, divide by the count of in-range taps, truncating
// cast back to uint8.  grayscale_quirk=1 writes the averaged red channel
// into all three outputs (the baseline kernel's behavior); 0 writes RGB
// (the tiled kernel's behavior).  Levels ping-pong through a scratch buffer
// exactly as many times as `depth`.
void rdt_box_filter_u8(const uint8_t* in, uint8_t* out, int h, int w,
                       int radius, int depth, int grayscale_quirk) {
    const size_t n = (size_t)h * w * 3;
    std::vector<uint8_t> a(in, in + n), b(n);
    const uint8_t* src = a.data();
    uint8_t* dst = (depth == 1) ? out : b.data();

    for (int level = 0; level < depth; ++level) {
        for (int y = 0; y < h; ++y) {
            for (int x = 0; x < w; ++x) {
                float acc[3] = {0.f, 0.f, 0.f};
                float norm = 0.f;
                for (int dy = -radius; dy <= radius; ++dy) {
                    const int ny = y + dy;
                    if (ny < 0 || ny >= h) continue;
                    for (int dx = -radius; dx <= radius; ++dx) {
                        const int nx = x + dx;
                        if (nx < 0 || nx >= w) continue;
                        const uint8_t* p = src + ((size_t)ny * w + nx) * 3;
                        acc[0] += p[0];
                        acc[1] += p[1];
                        acc[2] += p[2];
                        norm += 1.f;
                    }
                }
                uint8_t* q = dst + ((size_t)y * w + x) * 3;
                if (grayscale_quirk) {
                    const uint8_t g = (uint8_t)(acc[0] / norm);
                    q[0] = g; q[1] = g; q[2] = g;
                } else {
                    q[0] = (uint8_t)(acc[0] / norm);
                    q[1] = (uint8_t)(acc[1] / norm);
                    q[2] = (uint8_t)(acc[2] / norm);
                }
            }
        }
        // rotate buffers for the next level
        if (level + 1 < depth) {
            std::memcpy(a.data(), dst, n);
            src = a.data();
            dst = (level + 2 == depth) ? out : b.data();
        }
    }
}

}  // extern "C"
