// One sample's sky lookup, compose and running sum, and its adjoint, for
// NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package looks the sky up and composes each
// sample inside the jit of render_image_pallas (its kernels/megakernel.py),
// where XLA fuses the lookup, the compose and the sum into a few loops. The
// port ran the same math as plain PyTorch, some 110 launches a sample
// (ops/cubemap.py::sample_cubemap, kernels/megakernel.py::compose_sky), and
// under grad autograd kept 22 planes a pixel of that sample's intermediates.
// These kernels are that math, one launch a sample each way.
//
// sky_compose_kernel, per pixel of one sample: reads the ten planes of the
// forward megakernel (radiance r,g,b; the direction the path left the scene
// in; the throughput at that moment; the 0/1 miss flag), picks the cubemap
// face and (u, v) of the direction as ops/cubemap.py::face_uv does, clamps,
// remaps and truncates to the nearest texel, fetches it, and composes
// rgb = min(max(r + (sky * c) * miss, 0), 1), which it adds into the frame's
// running sum (total_out = total_in + rgb; total_out = rgb for the first
// sample; the two may be one buffer). Sample 0 of a frame that keeps a sky
// cache also writes the cache (the flat texel index, the texel where the
// path missed and 0 elsewhere, the miss flag) and composes with that texel,
// as the plain path's gather_texels does. Under grad it writes the sample's
// saved state instead of keeping the planes: an int32 word a pixel (bits
// 0-23 the texel of a packed sky or the face of a 1x1 float sky; bits 24-29
// each channel's clip weight code, 2 where the clip passes the cotangent, 1
// exactly on 0 or 1, 0 outside; bit 30 the miss flag) and the three
// throughput planes, and for a float sky larger than 1x1 the flat texel index
// as a fifth plane.
//
// sky_compose_adjoint_kernel writes the sample's (10,H,W) cotangent from the
// running sum's (H,W,3) cotangent g and the state:
//   g_r = g * w, where w is 1, 1/2 or 0 as autograd passes a cotangent
//         through maximum and minimum (half of it on a tie);
//   g_c = ((g * w) * miss) * sky;
//   g_miss = sum over the channels of (g * w) * (sky * c);
//   the direction planes 0: the nearest texel has no direction gradient.
//
// The bilinear arms (sky_compose_bilinear_kernel and its adjoint, for
// env_filter="bilinear" on a sky larger than 1x1; a 1x1 sky reads its face's
// texel under either filter and takes the kernels above) look the sky up as
// ops/cubemap.py::sample_cubemap(bilinear=True) does: the face's float texel
// coordinates (_face_texel_f), their floor, the next texel clamped to the
// face's last, the lerp along x on the two rows and then along y. Then the
// same compose, clip and sum. Under grad they keep seven planes a pixel: the
// word (clip codes and miss bit, no texel), the three throughput planes and
// the miss direction, from which the adjoint finds the four texels and the
// weights again. The adjoint writes every plane's cotangent, the direction's
// too: each channel's sky cotangent (g * w) * miss * c goes through the lerp
// to its weights wx and wy (summed over the channels), through the remap and
// the clamp (which passes it where -1 <= u <= 1, as torch.clamp's backward)
// to face_uv's u and v, and through u = n / s (n one component, s the
// dominant one's magnitude) to the direction, as autograd takes it through
// face_uv's divisions.
//
// What bounds them on this card: bytes. The forward reads 40 bytes of planes,
// the running sum's 12 and a texel a pixel, and writes 12 (plus 16 of state
// under grad, 28 in the bilinear arm); the adjoint reads 12 and the state
// (16, or 28) and writes 40. The bilinear arms read four texels a pixel and
// do some 51 (forward) and 100 (adjoint) operations a pixel, under one a
// byte where the card's arithmetic would bound them at 20. At 1280x960 that
// is 80-120 MB a launch, about 0.03 ms at 3.35 TB/s. The texel reads are the only ones not coalesced: neighbouring
// pixels that miss look at neighbouring texels, so a warp's reads fall on a
// few 32-byte sectors, and the pixels that hit all read one texel.
//
// The design: one thread per pixel, 256 a block, every plane read and written
// once in coalesced rows; the running sum and its cotangent are (H,W,3), the
// image's layout, so the frame needs no stack at the end.
//
// Numerics: frames must equal the plain compose bit for bit. The file is
// built with --fmad=false and no fast-math, so nothing is contracted; the
// face (u, v) is an IEEE division; the unpack scale is float32 of the double
// 1/255, what PyTorch multiplies by; the operations keep the plain order,
// ((sky * c) * miss), then r + it, then the lower clip, then the upper one;
// the bilinear arm's weights are fx - (float)floor(fx), and each lerp is
// a + (b - a) * w. The adjoints hold to autograd within a share of the
// magnitudes they sum; the bilinear adjoint sums the weights' terms in the
// order autograd adds them (the last use first), so that it agrees bit for
// bit where autograd keeps that order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// ops/cubemap.py's face order
constexpr int CF_FRONT = 0, CF_BACK = 1, CF_LEFT = 2, CF_RIGHT = 3, CF_TOP = 4, CF_BOTTOM = 5;

// The saved state's word (kernels/megakernel.py: SKY_TEXEL_MASK, SKY_CLIP_*,
// SKY_MISS_BIT).
constexpr int TEXEL_MASK = 0xFFFFFF;
constexpr int CLIP_SHIFT = 24;
constexpr int MISS_BIT = 1 << 30;
constexpr int CLIP_FULL = 2, CLIP_HALF = 1, CLIP_NONE = 0;

// float32 of the double 1/255: ops/cubemap.py::_unpack multiplies by the
// Python float, which PyTorch rounds to the tensor's float32.
constexpr float UNPACK = (float)(1.0 / 255.0);

struct Sky {
    const int* packed;  // (6*h*w,) 0x00RRGGBB, or null for float storage
    const float* r;     // (6*h*w,) float planes, or null for packed storage
    const float* g;
    const float* b;
    int h, w;

    __device__ __forceinline__ bool one() const { return h == 1 && w == 1; }
};

// torch.sign: 1, -1, or the zero itself.
__device__ __forceinline__ float sign_of(float x) {
    return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

// ops/cubemap.py::face_uv: the dominant axis picks the face, ties fall to
// the Z faces; an exact |x| == |y| tie with z == 0 saturates past the clamp
// with the numerator's sign.
__device__ __forceinline__ int face_uv(float dx, float dy, float dz, float& u, float& v) {
    const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
    if (ax > ay && ax > az) {
        u = (dx > 0.f ? -dz : dz) / ax;
        v = -dy / ax;
        return dx > 0.f ? CF_RIGHT : CF_LEFT;
    }
    if (ay > ax && ay > az) {
        u = dx / ay;
        v = (dy > 0.f ? dz : -dz) / ay;
        return dy > 0.f ? CF_TOP : CF_BOTTOM;
    }
    const float uz = dz > 0.f ? dx : -dx;
    const float vz = -dy;
    if (az == 0.f) {
        u = sign_of(uz) * 4.f;
        v = sign_of(vz) * 4.f;
    } else {
        u = uz / az;
        v = vz / az;
    }
    return dz > 0.f ? CF_FRONT : CF_BACK;
}

// torch.clamp(x, -1, 1), NaN kept.
__device__ __forceinline__ float clamp_unit(float x) {
    return x < -1.f ? -1.f : (x > 1.f ? 1.f : x);
}

// The nearest texel's flat index (ops/cubemap.py::texel_flat_index); the
// face alone for a 1x1 sky, as sample_cubemap's 6-way select reads it.
__device__ __forceinline__ int texel_index(const Sky& sky, float dx, float dy, float dz) {
    float u, v;
    const int face = face_uv(dx, dy, dz, u, v);
    if (sky.one()) return face;
    u = 0.5f * (clamp_unit(u) + 1.f);
    v = 0.5f * (clamp_unit(v) + 1.f);
    const int x = (int)(u * (float)(sky.w - 1));
    const int y = (int)(v * (float)(sky.h - 1));
    return (face * sky.h + y) * sky.w + x;
}

__device__ __forceinline__ void unpack(int t, float s[3]) {
    s[0] = (float)((t >> 16) & 0xFF) * UNPACK;
    s[1] = (float)((t >> 8) & 0xFF) * UNPACK;
    s[2] = (float)(t & 0xFF) * UNPACK;
}

__device__ __forceinline__ void fetch_float(const Sky& sky, int k, float s[3]) {
    s[0] = __ldg(sky.r + k);
    s[1] = __ldg(sky.g + k);
    s[2] = __ldg(sky.b + k);
}

// How the clip min(max(x, 0), 1) passes a cotangent: autograd halves it
// where x sits exactly on a bound and passes all of it inside (NaN too, as
// its comparisons are false).
__device__ __forceinline__ int clip_code(float x) {
    if (x < 0.f || x > 1.f) return CLIP_NONE;
    if (x == 0.f || x == 1.f) return CLIP_HALF;
    return CLIP_FULL;
}

// The compose of one pixel: per channel x = r + (sky * c) * miss, clipped to
// [0, 1] and added into the running sum. Returns the three clip codes in the
// word's bits 24-29; with a state, writes the throughput to its planes 1-3.
__device__ __forceinline__ int compose_sum(const float* __restrict__ planes, const float* total_in,
                                           float* total_out, const float s[3], float missf,
                                           int i, size_t N, int* __restrict__ state) {
    int codes = 0;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        const float c = planes[(6 + ch) * N + i];
        const float x = planes[ch * N + i] + (s[ch] * c) * missf;
        float y = x < 0.f ? 0.f : x;
        y = y > 1.f ? 1.f : y;
        const size_t o = 3 * (size_t)i + ch;
        total_out[o] = total_in != nullptr ? total_in[o] + y : y;
        codes |= clip_code(x) << (CLIP_SHIFT + 2 * ch);
        if (state != nullptr) state[(1 + ch) * N + i] = __float_as_int(c);
    }
    return codes;
}

// The cotangents of the radiance, throughput and miss planes from the
// running sum's cotangent g: the clip passes all, half or none of each
// channel's (g * w), then through ((sky * c) * miss). Returns each channel's
// cotangent of the sky radiance, (g * w) * miss * c, in gs.
__device__ __forceinline__ void compose_adjoint(const float* __restrict__ g_total, int word,
                                                const float c[3], const float s[3], int i,
                                                size_t N, float* __restrict__ g_planes,
                                                float gs[3]) {
    const float missf = (word & MISS_BIT) ? 1.f : 0.f;
    float t[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        const float g = g_total[3 * (size_t)i + ch];
        const int code = (word >> (CLIP_SHIFT + 2 * ch)) & 3;
        const float gx = code == CLIP_FULL ? g : (code == CLIP_HALF ? g * 0.5f : 0.f);
        g_planes[ch * N + i] = gx;
        g_planes[(6 + ch) * N + i] = (gx * missf) * s[ch];
        t[ch] = gx * (s[ch] * c[ch]);
        gs[ch] = (gx * missf) * c[ch];
    }
    g_planes[9 * N + i] = (t[0] + t[1]) + t[2];
}

__device__ __forceinline__ void fetch(const Sky& sky, int k, float s[3]) {
    if (sky.packed != nullptr) {
        unpack(__ldg(sky.packed + k), s);
    } else {
        fetch_float(sky, k, s);
    }
}

// The bilinear lookup's four texels (flat indices of corners 00, 01 = x + 1,
// 10 = y + 1, 11) and weights, from face_uv's face, u and v
// (ops/cubemap.py::_face_texel_f and sample_cubemap's floor and clamp).
struct Lerp {
    int k[4];
    float wx, wy;
};

__device__ __forceinline__ Lerp bilinear_lerp(const Sky& sky, int face, float u, float v) {
    const float fx = (0.5f * (clamp_unit(u) + 1.f)) * (float)(sky.w - 1);
    const float fy = (0.5f * (clamp_unit(v) + 1.f)) * (float)(sky.h - 1);
    const int x0 = (int)floorf(fx), y0 = (int)floorf(fy);
    const int x1 = min(x0 + 1, sky.w - 1), y1 = min(y0 + 1, sky.h - 1);
    const int r0 = (face * sky.h + y0) * sky.w, r1 = (face * sky.h + y1) * sky.w;
    return {{r0 + x0, r0 + x1, r1 + x0, r1 + x1}, fx - (float)x0, fy - (float)y0};
}

// The lerp of the four texels, channel by channel in sample_cubemap's order:
// top = c00 + (c01 - c00) * wx, bot = c10 + (c11 - c10) * wx, then
// s = top + (bot - top) * wy. Keeps the x differences and top and bot for
// the adjoint.
struct Lerped {
    float s[3], top[3], bot[3], d0[3], d1[3];
};

__device__ __forceinline__ Lerped lerp_texels(const Sky& sky, const Lerp& l) {
    float c00[3], c01[3], c10[3], c11[3];
    fetch(sky, l.k[0], c00);
    fetch(sky, l.k[1], c01);
    fetch(sky, l.k[2], c10);
    fetch(sky, l.k[3], c11);
    Lerped o;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        o.d0[ch] = c01[ch] - c00[ch];
        o.d1[ch] = c11[ch] - c10[ch];
        o.top[ch] = c00[ch] + o.d0[ch] * l.wx;
        o.bot[ch] = c10[ch] + o.d1[ch] * l.wx;
        o.s[ch] = o.top[ch] + (o.bot[ch] - o.top[ch]) * l.wy;
    }
    return o;
}

// The direction's cotangent from those of face_uv's u and v before the
// clamp, as autograd takes them back through face_uv: u = n_u / s and
// v = n_v / s, s the dominant component's magnitude, the numerators the two
// others up to sign; a division passes grad / s to its numerator and
// -grad * ((n / s) / s) to s, whose abs passes it times the component's
// sign. The exact |x| == |y| tie with z == 0 saturates u and v to constants
// and passes nothing.
__device__ __forceinline__ void face_uv_adjoint(float dx, float dy, float dz, float gu, float gv,
                                                float g[3]) {
    const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
    g[0] = g[1] = g[2] = 0.f;
    if (ax > ay && ax > az) {
        const float nu = dx > 0.f ? -dz : dz, nv = -dy;
        const float gnu = gu / ax, gnv = gv / ax;
        const float gs = -gu * ((nu / ax) / ax) + -gv * ((nv / ax) / ax);
        g[0] = dx > 0.f ? gs : -gs;
        g[1] = -gnv;
        g[2] = dx > 0.f ? -gnu : gnu;
    } else if (ay > ax && ay > az) {
        const float nu = dx, nv = dy > 0.f ? dz : -dz;
        const float gnu = gu / ay, gnv = gv / ay;
        const float gs = -gu * ((nu / ay) / ay) + -gv * ((nv / ay) / ay);
        g[0] = gnu;
        g[1] = dy > 0.f ? gs : -gs;
        g[2] = dy > 0.f ? gnv : -gnv;
    } else if (az != 0.f) {
        const float nu = dz > 0.f ? dx : -dx, nv = -dy;
        const float gnu = gu / az, gnv = gv / az;
        const float gs = -gu * ((nu / az) / az) + -gv * ((nv / az) / az);
        g[0] = dz > 0.f ? gnu : -gnu;
        g[1] = -gnv;
        g[2] = dz > 0.f ? gs : -gs;
    }
}

__global__ void __launch_bounds__(THREADS)
sky_compose_kernel(const float* __restrict__ planes, const float* total_in, float* total_out,
                   Sky sky, int n, int* __restrict__ state, int* __restrict__ cache_flat,
                   int* __restrict__ cache_packed, unsigned char* __restrict__ cache_miss) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const size_t N = (size_t)n;
    const float missf = planes[9 * N + i];
    const bool miss = missf > 0.5f;
    const int k = texel_index(sky, planes[3 * N + i], planes[4 * N + i], planes[5 * N + i]);
    float s[3];
    int word;
    if (sky.packed != nullptr) {
        int tex = __ldg(sky.packed + k);
        if (cache_flat != nullptr) {
            // sample 0 of a cached frame: the cache's texel, 0 where the
            // path did not miss (gather_texels)
            tex = miss ? tex : 0;
            cache_flat[i] = k;
            cache_packed[i] = tex;
            cache_miss[i] = miss ? 1 : 0;
        }
        unpack(tex, s);
        word = tex;
    } else {
        fetch_float(sky, k, s);
        word = sky.one() ? k : 0;
    }
    if (miss) word |= MISS_BIT;
    word |= compose_sum(planes, total_in, total_out, s, missf, i, N, state);
    if (state != nullptr) {
        state[i] = word;
        if (sky.packed == nullptr && !sky.one()) state[4 * N + i] = k;
    }
}

__global__ void __launch_bounds__(THREADS)
sky_compose_adjoint_kernel(const float* __restrict__ g_total, const int* __restrict__ state,
                           Sky sky, int n, float* __restrict__ g_planes) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const size_t N = (size_t)n;
    const int word = state[i];
    float s[3];
    if (sky.packed != nullptr) {
        unpack(word & TEXEL_MASK, s);
    } else {
        fetch_float(sky, sky.one() ? (word & TEXEL_MASK) : state[4 * N + i], s);
    }
    float c[3], gs[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        c[ch] = __int_as_float(state[(1 + ch) * N + i]);
        g_planes[(3 + ch) * N + i] = 0.f;
    }
    compose_adjoint(g_total, word, c, s, i, N, g_planes, gs);
}

__global__ void __launch_bounds__(THREADS)
sky_compose_bilinear_kernel(const float* __restrict__ planes, const float* total_in,
                            float* total_out, Sky sky, int n, int* __restrict__ state) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const size_t N = (size_t)n;
    const float dx = planes[3 * N + i], dy = planes[4 * N + i], dz = planes[5 * N + i];
    float u, v;
    const int face = face_uv(dx, dy, dz, u, v);
    const Lerped l = lerp_texels(sky, bilinear_lerp(sky, face, u, v));
    const float missf = planes[9 * N + i];
    int word = compose_sum(planes, total_in, total_out, l.s, missf, i, N, state);
    if (state != nullptr) {
        if (missf > 0.5f) word |= MISS_BIT;
        state[i] = word;
        state[4 * N + i] = __float_as_int(dx);
        state[5 * N + i] = __float_as_int(dy);
        state[6 * N + i] = __float_as_int(dz);
    }
}

__global__ void __launch_bounds__(THREADS)
sky_compose_bilinear_adjoint_kernel(const float* __restrict__ g_total,
                                    const int* __restrict__ state, Sky sky, int n,
                                    float* __restrict__ g_planes) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const size_t N = (size_t)n;
    const int word = state[i];
    const float dx = __int_as_float(state[4 * N + i]);
    const float dy = __int_as_float(state[5 * N + i]);
    const float dz = __int_as_float(state[6 * N + i]);
    float u, v;
    const int face = face_uv(dx, dy, dz, u, v);
    const Lerp lerp = bilinear_lerp(sky, face, u, v);
    const Lerped l = lerp_texels(sky, lerp);
    float c[3], gs[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) c[ch] = __int_as_float(state[(1 + ch) * N + i]);
    compose_adjoint(g_total, word, c, l.s, i, N, g_planes, gs);
    // s = top + (bot - top) * wy, top and bot lerps along x; the weights'
    // cotangents add their terms in autograd's order, the last use first
    // (ops/cubemap.py::bilinear_adjoint)
    float gtop[3], gbot[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        gbot[ch] = gs[ch] * lerp.wy;
        gtop[ch] = gs[ch] - gbot[ch];
    }
    const float gwy = (gs[2] * (l.bot[2] - l.top[2]) + gs[1] * (l.bot[1] - l.top[1]))
                      + gs[0] * (l.bot[0] - l.top[0]);
    const float gwx = ((((gbot[2] * l.d1[2] + gbot[1] * l.d1[1]) + gbot[0] * l.d1[0])
                        + gtop[2] * l.d0[2]) + gtop[1] * l.d0[1]) + gtop[0] * l.d0[0];
    // fx = (0.5 * (clamp(u) + 1)) * (w - 1), fy likewise
    const float gu = (u >= -1.f && u <= 1.f) ? (gwx * (float)(sky.w - 1)) * 0.5f : 0.f;
    const float gv = (v >= -1.f && v <= 1.f) ? (gwy * (float)(sky.h - 1)) * 0.5f : 0.f;
    float g[3];
    face_uv_adjoint(dx, dy, dz, gu, gv, g);
    g_planes[3 * N + i] = g[0];
    g_planes[4 * N + i] = g[1];
    g_planes[5 * N + i] = g[2];
}

}  // namespace

// Launches the forward kernel over one sample of n = H*W pixels on `stream`:
// the bilinear arm where `bilinear` is not 0 (a sky larger than 1x1, no
// cache), else the nearest texel. planes: (10,H,W) float32; total_in: (H,W,3)
// float32 or null (the first sample); total_out: (H,W,3) float32, may be
// total_in; the sky: packed (6*sky_h*sky_w,) int32, or r, g, b float32 planes
// (the other null); state: (4, 5 or, bilinear, 7,H,W) int32 or null (no
// grad); cache_flat, cache_packed (H,W) int32 and cache_miss (H,W) bool, all
// three or none. Device pointers. Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int rt_sky_compose(const float* planes, const float* total_in, float* total_out,
                              const int* packed, const float* r, const float* g, const float* b,
                              int sky_h, int sky_w, int n, int bilinear, int* state,
                              int* cache_flat, int* cache_packed, unsigned char* cache_miss,
                              void* stream) {
    if (n <= 0) return 0;
    const Sky sky{packed, r, g, b, sky_h, sky_w};
    const int blocks = (n + THREADS - 1) / THREADS;
    if (bilinear) {
        sky_compose_bilinear_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            planes, total_in, total_out, sky, n, state);
    } else {
        sky_compose_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            planes, total_in, total_out, sky, n, state, cache_flat, cache_packed, cache_miss);
    }
    return (int)cudaGetLastError();
}

// Launches the adjoint over one sample (the bilinear arm where `bilinear` is
// not 0): g_total (H,W,3) float32, state as the forward wrote it, the same
// sky, g_planes (10,H,W) float32 (every plane written). Returns the
// cudaError_t of the launch.
extern "C" int rt_sky_compose_adjoint(const float* g_total, const int* state, const int* packed,
                                      const float* r, const float* g, const float* b, int sky_h,
                                      int sky_w, int n, int bilinear, float* g_planes,
                                      void* stream) {
    if (n <= 0) return 0;
    const Sky sky{packed, r, g, b, sky_h, sky_w};
    const int blocks = (n + THREADS - 1) / THREADS;
    if (bilinear) {
        sky_compose_bilinear_adjoint_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            g_total, state, sky, n, g_planes);
    } else {
        sky_compose_adjoint_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            g_total, state, sky, n, g_planes);
    }
    return (int)cudaGetLastError();
}

// Text of a cudaError_t, for the wrapper's exception.
extern "C" const char* rt_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
