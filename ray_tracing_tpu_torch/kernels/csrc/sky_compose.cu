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
// sample; the two may be one buffer). Under grad it writes the sample's
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
// soft_silhouettes_kernel and soft_silhouettes_adjoint_kernel
// replace no TPU kernel either: they are render/integrator.py::
// soft_silhouette_composite, the blend of a fit's frame with the soft primary
// visibility, which the JAX package leaves to XLA and the port ran as plain
// PyTorch (some 800 launches a frame under grad, and an autograd graph of
// about 100 planes a frame). One thread a pixel of a 32x8 block: the
// unjittered primary ray from the camera pack (rows row0 .. of a
// norm_height-tall frame), one loop over the rows (staged in shared memory)
// for the closest hit and the runner-up, the winner's coverage, on a miss a
// second loop for the best outside coverage, the sky at the ray's direction
// (the lookups above), the proxies and the blend. The adjoint finds all of
// that again from the colour, the rows and the camera, and takes the
// cotangent through the coverage of the one object alpha reads, the
// albedo and emission of the one object bg reads and, for the camera, the
// bilinear lookup's direction adjoint; the rows' and the camera's
// cotangents are summed over each warp by object and over the block in
// shared memory (rt_backward.cuh's route, as the backward megakernels do),
// then added with one atomic a float a block. The frame equals the plain
// composite bit for bit: its steps are PyTorch's CUDA steps in their order,
// sigmoid as 1 / (1 + exp(-x)) and a box's extent sum over 3 as a product
// with float(1/3), as PyTorch's CUDA division by a Python scalar computes it.
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

#include "rt_backward.cuh"

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

// The direction's cotangent of the bilinear lookup at (dx, dy, dz) from each
// channel's cotangent gs of the looked-up radiance, given face_uv's u and v
// and the lerp the lookup took (ops/cubemap.py::bilinear_adjoint).
__device__ __forceinline__ void lerp_adjoint(const Sky& sky, float dx, float dy, float dz, float u,
                                             float v, const Lerp& lerp, const Lerped& l,
                                             const float gs[3], float g[3]) {
    // s = top + (bot - top) * wy, top and bot lerps along x; the weights'
    // cotangents add their terms in autograd's order, the last use first
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
    face_uv_adjoint(dx, dy, dz, gu, gv, g);
}

__global__ void __launch_bounds__(THREADS)
sky_compose_kernel(const float* __restrict__ planes, const float* total_in, float* total_out,
                   Sky sky, int n, int* __restrict__ state) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const size_t N = (size_t)n;
    const float missf = planes[9 * N + i];
    const bool miss = missf > 0.5f;
    const int k = texel_index(sky, planes[3 * N + i], planes[4 * N + i], planes[5 * N + i]);
    float s[3];
    int word;
    if (sky.packed != nullptr) {
        const int tex = __ldg(sky.packed + k);
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
    float g[3];
    lerp_adjoint(sky, dx, dy, dz, u, v, lerp, l, gs, g);
    g_planes[3 * N + i] = g[0];
    g_planes[4 * N + i] = g[1];
    g_planes[5 * N + i] = g[2];
}


// ---------------------------------------------------------------------------
// The soft silhouettes: render/integrator.py::soft_silhouette_composite over
// one frame, one thread a pixel, and its adjoint.
// ---------------------------------------------------------------------------

using rt::V3;
using rt::v3;
using rt::BIG;
using rt::HIT_THRESHOLD;
using rt::SCENE_COLS;
using rt::TYPE_SPHERE;

// What a launch is told besides its pointers.
struct SoftFrame {
    int n;                              // objects: rows of the scene
    int width, height, norm_height, row0;
    float temp;                         // config.soft_silhouette_temp
    bool bilinear;                      // the sky's bilinear arm
};

// torch.maximum and torch.minimum (a NaN wins); torch.clamp(x, min=m) (a NaN
// is kept).
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
    return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float clamp_min(float x, float m) { return x < m ? m : x; }

// torch.sigmoid on the card: 1 / (1 + exp(-x)).
__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Vec3.clip(0, 1): min(max(x, 0), 1).
__device__ __forceinline__ float clip_unit(float x) { return min_nan(max_nan(x, 0.0f), 1.0f); }

// The cotangent the clip passes: all, half exactly on 0 or 1, none outside.
__device__ __forceinline__ float clip_pass(float x, float g) {
    const int code = clip_code(x);
    return code == CLIP_FULL ? g : (code == CLIP_HALF ? g * 0.5f : 0.0f);
}

// The backward of torch.minimum / torch.maximum: the cotangent goes to the
// smaller / larger input, half of it to each on a tie, as autograd has it.
__device__ __forceinline__ void min_adjoint(float a, float b, float g, float& ga, float& gb) {
    ga = a == b ? g * 0.5f : (a < b ? g : 0.0f);
    gb = a == b ? g * 0.5f : (b < a ? g : 0.0f);
}
__device__ __forceinline__ void max_adjoint(float a, float b, float g, float& ga, float& gb) {
    ga = a == b ? g * 0.5f : (a > b ? g : 0.0f);
    gb = a == b ? g * 0.5f : (b > a ? g : 0.0f);
}

// A sphere's coverage of the ray (ro, d): the sigmoid of its perpendicular
// distance margin over temp * radius; `along` the centre's distance along
// the ray (the coverage counts only where it is positive).
__device__ __forceinline__ float sphere_cover(const float* row, V3 ro, V3 d, float temp,
                                              float& along) {
    const V3 oc = v3(row[0], row[1], row[2]) - ro;
    along = rt::dot(oc, d);
    const float d_perp = sqrtf(clamp_min(rt::dot(oc, oc) - along * along, 1e-12f));
    const float r = row[3];
    return sigmoid((r - d_perp) / (clamp_min(r, 1e-6f) * temp));
}

// One slab of _soft_slab_coverage: the ray's entry and exit along one axis,
// +-BIG (inside) or -+BIG (outside) where the ray is parallel to it.
struct Slab {
    float ta, tb, safe, tmin, tmax;
    bool zero;
};

__device__ __forceinline__ Slab slab(float lo, float hi, float o, float dc) {
    Slab s;
    s.zero = dc == 0.0f;
    s.safe = s.zero ? 1.0f : dc;
    s.ta = (lo - o) / s.safe;
    s.tb = (hi - o) / s.safe;
    s.tmin = min_nan(s.ta, s.tb);
    s.tmax = max_nan(s.ta, s.tb);
    if (s.zero) {
        const bool inside = o > lo && o < hi;
        s.tmin = inside ? -BIG : BIG;
        s.tmax = inside ? BIG : -BIG;
    }
    return s;
}

// A box's coverage: the sigmoid of the slab overlap (far - max(near, 0))
// clamped to +-60 q, over q = temp * the box's mean extent. PyTorch's CUDA
// division of the extents' sum by 3.0 multiplies by float(1/3).
struct SlabCover {
    Slab s[3];
    float near1, near, far1, far, m0, size3, q, m1, m, z, a;
};

__device__ __forceinline__ SlabCover slab_cover(const float* row, V3 ro, V3 d, float temp) {
    SlabCover c;
    const float hx = row[0] + row[3], hy = row[1] + row[4], hz = row[2] + row[5];
    c.s[0] = slab(row[0], hx, ro.x, d.x);
    c.s[1] = slab(row[1], hy, ro.y, d.y);
    c.s[2] = slab(row[2], hz, ro.z, d.z);
    c.near1 = max_nan(c.s[0].tmin, c.s[1].tmin);
    c.near = max_nan(c.near1, c.s[2].tmin);
    c.far1 = min_nan(c.s[0].tmax, c.s[1].tmax);
    c.far = min_nan(c.far1, c.s[2].tmax);
    c.m0 = c.far - clamp_min(c.near, 0.0f);
    c.size3 = (hx - row[0] + hy - row[1] + hz - row[2]) * (1.0f / 3.0f);
    c.q = clamp_min(c.size3, 1e-6f) * temp;
    c.m1 = max_nan(c.m0, c.q * -60.0f);
    c.m = min_nan(c.m1, c.q * 60.0f);
    c.z = c.m / c.q;
    c.a = sigmoid(c.z);
    return c;
}

// An object's coverage and whether it counts (a sphere's only in front).
__device__ __forceinline__ float cover_of(const float* row, V3 ro, V3 d, float temp, bool& front) {
    if (row[15] == TYPE_SPHERE) {
        float along;
        const float a = sphere_cover(row, ro, d, temp, along);
        front = along > 0.0f;
        return a;
    }
    front = true;
    return slab_cover(row, ro, d, temp).a;
}

// The sky radiance at d before its clip (sample_cubemap).
__device__ __forceinline__ void sky_at(const Sky& sky, bool bilinear, V3 d, float s[3]) {
    if (bilinear) {
        float u, v;
        const int face = face_uv(d.x, d.y, d.z, u, v);
        const Lerped l = lerp_texels(sky, bilinear_lerp(sky, face, u, v));
        s[0] = l.s[0];
        s[1] = l.s[1];
        s[2] = l.s[2];
    } else {
        fetch(sky, texel_index(sky, d.x, d.y, d.z), s);
    }
}

// One pixel of the composite out = result * alpha + bg * (1 - alpha), with
// what its adjoint reads.
struct SoftPixel {
    float u, v, cu, cv;
    V3 ro, rd, d;      // the unjittered primary ray, rd unnormalised, d = normalize(rd)
    bool hit;
    bool proxy;        // bg is clip(x), a proxy's; else the sky
    int geo;           // the object whose coverage alpha is (-1: alpha is constant)
    int mat;           // the object whose albedo and emission x takes (-1: none)
    float alpha;
    float s[3], sky0[3], x[3], bg[3];
};

// The composite's pixel (x, y) of the frame: the primary ray from the camera
// pack, its closest hit and the closest other hit (the runner-up) in one
// loop over the objects (strict <: the first of equal t wins, as trace's
// scan and the composite's select chain have it), the winner's coverage; a
// pixel that misses loops over the objects again for the best coverage
// (its first of equal coverages); then the sky at d.
__device__ __forceinline__ SoftPixel soft_pixel(const SoftFrame& f, const float* cam,
                                                const float* rows, const Sky& sky, int x, int y) {
    SoftPixel p;
    const int wm1 = f.width - 1 > 1 ? f.width - 1 : 1;
    const int hm1 = f.norm_height - 1 > 1 ? f.norm_height - 1 : 1;
    p.u = 1.0f - (float)x / (float)wm1;
    p.v = 1.0f - ((float)y + (float)f.row0) / (float)hm1;
    p.cu = (p.u - 0.5f) * cam[12];
    p.cv = (p.v - 0.5f) * cam[13];
    p.rd = v3(p.cu * cam[3] + p.cv * cam[6] - cam[9], p.cu * cam[4] + p.cv * cam[7] - cam[10],
              p.cu * cam[5] + p.cv * cam[8] - cam[11]);
    p.ro = v3(cam[0], cam[1], cam[2]);
    const rt::Ray ray = rt::make_ray(p.ro, p.rd);
    p.d = ray.d;

    float t1 = BIG, t2 = BIG;
    int win = -1, second = -1;
    for (int i = 0; i < f.n; ++i) {
        int axis;
        const float t = rt::intersect_row(ray, rows + i * SCENE_COLS, axis);
        if (t < t1) {
            t2 = t1;
            second = win;
            t1 = t;
            win = i;
        } else if (t < t2) {
            t2 = t;
            second = i;
        }
    }
    p.hit = t1 < HIT_THRESHOLD;
    if (p.hit) {
        bool front;
        const float a = cover_of(rows + win * SCENE_COLS, p.ro, p.d, f.temp, front);
        p.alpha = front ? a : 1.0f;
        p.geo = front ? win : -1;
        p.proxy = t2 < HIT_THRESHOLD;
        p.mat = p.proxy ? second : -1;
    } else {
        float a_out = 0.0f;
        int best = -1;
        for (int i = 0; i < f.n; ++i) {
            bool front;
            const float a = cover_of(rows + i * SCENE_COLS, p.ro, p.d, f.temp, front);
            const float cover = front ? a : 0.0f;
            if (cover > a_out) {
                a_out = cover;
                best = i;
            }
        }
        p.alpha = 1.0f - a_out;
        p.geo = best;
        p.proxy = true;
        p.mat = best;
    }
    sky_at(sky, f.bilinear, p.d, p.s);
    const float* m = rows + (p.mat >= 0 ? p.mat : 0) * SCENE_COLS;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        p.sky0[ch] = clip_unit(p.s[ch]);
        const float alb = p.mat >= 0 ? m[6 + ch] : 0.0f;
        const float emis = p.mat >= 0 ? m[12 + ch] : 0.0f;
        p.x[ch] = emis + alb * p.sky0[ch];
        p.bg[ch] = p.proxy ? clip_unit(p.x[ch]) : p.sky0[ch];
    }
    return p;
}

// The cotangents of a sphere's row (columns 0-3: centre, radius; added into
// g_row), of d and of ro from ga, that of its coverage, in autograd's steps.
__device__ __forceinline__ void sphere_cover_adjoint(const float* row, V3 ro, V3 d, float temp,
                                                     float ga, float* g_row, V3& g_d, V3& g_ro) {
    const V3 oc = v3(row[0], row[1], row[2]) - ro;
    const float along = rt::dot(oc, d);
    const float pd2 = rt::dot(oc, oc) - along * along;
    const float d_perp = sqrtf(clamp_min(pd2, 1e-12f));
    const float r = row[3];
    const float den = clamp_min(r, 1e-6f) * temp;
    const float z = (r - d_perp) / den;
    const float a = sigmoid(z);
    const float gz = (ga * (1.0f - a)) * a;
    const float g_num = gz / den;
    float g_r = g_num;
    if (r >= 1e-6f) g_r = g_r + (-gz * (z / den)) * temp;
    const float g_pd2 = pd2 >= 1e-12f ? -g_num / (2.0f * d_perp) : 0.0f;
    const float g_along = (-g_pd2 * along) * 2.0f;
    const V3 g_oc = d * g_along + oc * (2.0f * g_pd2);
    g_d = g_d + oc * g_along;
    g_ro = g_ro - g_oc;
    g_row[0] += g_oc.x;
    g_row[1] += g_oc.y;
    g_row[2] += g_oc.z;
    g_row[3] += g_r;
}

// The same for a box: columns 0-5 (origin, size; hi = origin + size).
__device__ __forceinline__ void slab_cover_adjoint(const float* row, V3 ro, V3 d, float temp,
                                                   float ga, float* g_row, V3& g_d, V3& g_ro) {
    const SlabCover c = slab_cover(row, ro, d, temp);
    const float gz = (ga * (1.0f - c.a)) * c.a;
    const float g_m = gz / c.q;
    float g_q = -gz * (c.z / c.q);
    float g_m1, g_hi, g_m0, g_lo;
    min_adjoint(c.m1, c.q * 60.0f, g_m, g_m1, g_hi);
    max_adjoint(c.m0, c.q * -60.0f, g_m1, g_m0, g_lo);
    g_q = g_q + (g_hi * 60.0f + g_lo * -60.0f);
    const float g_size = c.size3 >= 1e-6f ? (g_q * temp) * (1.0f / 3.0f) : 0.0f;
    const float g_near = c.near >= 0.0f ? -g_m0 : 0.0f;
    float g_far1, g_near1, g_tmin[3], g_tmax[3];
    min_adjoint(c.far1, c.s[2].tmax, g_m0, g_far1, g_tmax[2]);
    min_adjoint(c.s[0].tmax, c.s[1].tmax, g_far1, g_tmax[0], g_tmax[1]);
    max_adjoint(c.near1, c.s[2].tmin, g_near, g_near1, g_tmin[2]);
    max_adjoint(c.s[0].tmin, c.s[1].tmin, g_near1, g_tmin[0], g_tmin[1]);
    float g_o[3] = {0.0f, 0.0f, 0.0f}, g_dc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const Slab& s = c.s[k];
        float g_lo_k = -g_size, g_hi_k = g_size;
        if (!s.zero) {
            float ga1, gb1, ga2, gb2;
            min_adjoint(s.ta, s.tb, g_tmin[k], ga1, gb1);
            max_adjoint(s.ta, s.tb, g_tmax[k], ga2, gb2);
            const float g_ta = ga1 + ga2, g_tb = gb1 + gb2;
            g_lo_k = g_lo_k + g_ta / s.safe;
            g_hi_k = g_hi_k + g_tb / s.safe;
            g_o[k] = -(g_ta / s.safe) - g_tb / s.safe;
            g_dc[k] = -g_ta * (s.ta / s.safe) + -g_tb * (s.tb / s.safe);
        }
        g_row[k] += g_lo_k + g_hi_k;
        g_row[3 + k] += g_hi_k;
    }
    g_d = g_d + v3(g_dc[0], g_dc[1], g_dc[2]);
    g_ro = g_ro + v3(g_o[0], g_o[1], g_o[2]);
}

// The cotangent of rd from that of d = normalize(rd) (Vec3.normalize: a
// short vector passes through).
__device__ __forceinline__ V3 normalize_adjoint(V3 rd, V3 g_d) {
    const float n = sqrtf(rt::dot(rd, rd));
    if (n < rt::NORMALIZE_EPS) return g_d;
    const float inv = 1.0f / n;
    const float g_n = -rt::dot(g_d, rd) * (inv * inv);
    return g_d * inv + rd * (2.0f * (g_n / (2.0f * n)));
}

// The rows of the scene into shared memory, by the whole block.
__device__ __forceinline__ void stage_rows(const float* __restrict__ scene, int n, float* dst) {
    const int tid = threadIdx.y * rt::BLOCK_W + threadIdx.x;
    for (int i = tid; i < n * SCENE_COLS; i += rt::THREADS) dst[i] = scene[i];
}

__global__ void __launch_bounds__(rt::THREADS)
soft_silhouettes_kernel(const float* __restrict__ result, const float* __restrict__ scene,
                        const float* __restrict__ cam, Sky sky, SoftFrame f,
                        float* __restrict__ out) {
    extern __shared__ float s_soft[];
    __shared__ float s_cam[16];
    stage_rows(scene, f.n, s_soft);
    const int tid = threadIdx.y * rt::BLOCK_W + threadIdx.x;
    if (tid < 16) s_cam[tid] = cam[tid];
    __syncthreads();
    const int x = blockIdx.x * rt::BLOCK_W + threadIdx.x;
    const int y = blockIdx.y * rt::BLOCK_H + threadIdx.y;
    if (x >= f.width || y >= f.height) return;
    const SoftPixel p = soft_pixel(f, s_cam, s_soft, sky, x, y);
    const size_t o = 3 * ((size_t)y * f.width + x);
    const float keep = 1.0f - p.alpha;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) out[o + ch] = result[o + ch] * p.alpha + p.bg[ch] * keep;
}

// g_scene (n,16) and g_cam (16,) are zero at launch and null where no
// cotangent is asked for; g_result may be null too.
__global__ void __launch_bounds__(rt::THREADS)
soft_silhouettes_adjoint_kernel(const float* __restrict__ g_out, const float* __restrict__ result,
                                const float* __restrict__ scene, const float* __restrict__ cam,
                                Sky sky, SoftFrame f, float* __restrict__ g_result,
                                float* __restrict__ g_scene, float* __restrict__ g_cam) {
    // dynamic shared memory: the rows, then their cotangent
    extern __shared__ float s_soft[];
    __shared__ float s_cam[16];
    __shared__ float s_gcam[16];
    const int table = f.n * SCENE_COLS;
    float* s_grad = s_soft + table;
    stage_rows(scene, f.n, s_soft);
    const int tid = threadIdx.y * rt::BLOCK_W + threadIdx.x;
    if (g_scene != nullptr) {
        for (int i = tid; i < table; i += rt::THREADS) s_grad[i] = 0.0f;
    }
    if (tid < 16) {
        s_cam[tid] = cam[tid];
        s_gcam[tid] = 0.0f;
    }
    __syncthreads();
    const int x = blockIdx.x * rt::BLOCK_W + threadIdx.x;
    const int y = blockIdx.y * rt::BLOCK_H + threadIdx.y;
    const bool inside = x < f.width && y < f.height;
    // the coverage's object (columns 0-5) and the proxy's (6-14)
    float g_geo[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float g_mat[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float gc[14];
#pragma unroll
    for (int k = 0; k < 14; ++k) gc[k] = 0.0f;
    int geo = -1, mat = -1;
    if (inside) {
        const SoftPixel p = soft_pixel(f, s_cam, s_soft, sky, x, y);
        const size_t o = 3 * ((size_t)y * f.width + x);
        float g[3], res[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
            g[ch] = g_out[o + ch];
            res[ch] = result[o + ch];
            if (g_result != nullptr) g_result[o + ch] = g[ch] * p.alpha;
        }
        const float g_alpha = (g[0] * res[0] + g[1] * res[1] + g[2] * res[2])
                              - (g[0] * p.bg[0] + g[1] * p.bg[1] + g[2] * p.bg[2]);
        const float keep = 1.0f - p.alpha;
        float g_sky0[3];
        const float* m = s_soft + (p.mat >= 0 ? p.mat : 0) * SCENE_COLS;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
            const float g_bg = g[ch] * keep;
            if (p.proxy) {
                const float gx = clip_pass(p.x[ch], g_bg);
                g_mat[ch] = gx * p.sky0[ch];
                g_mat[6 + ch] = gx;
                g_sky0[ch] = p.mat >= 0 ? gx * m[6 + ch] : 0.0f;
            } else {
                g_sky0[ch] = g_bg;
            }
        }
        mat = g_scene != nullptr ? p.mat : -1;
        V3 g_d = v3(0.0f, 0.0f, 0.0f), g_ro = v3(0.0f, 0.0f, 0.0f);
        if (p.geo >= 0) {
            const float* row = s_soft + p.geo * SCENE_COLS;
            const float g_cov = p.hit ? g_alpha : -g_alpha;
            if (row[15] == TYPE_SPHERE) {
                sphere_cover_adjoint(row, p.ro, p.d, f.temp, g_cov, g_geo, g_d, g_ro);
            } else {
                slab_cover_adjoint(row, p.ro, p.d, f.temp, g_cov, g_geo, g_d, g_ro);
            }
            geo = g_scene != nullptr ? p.geo : -1;
        }
        if (g_cam != nullptr) {
            if (f.bilinear) {
                float gs[3], gdir[3], u, v;
#pragma unroll
                for (int ch = 0; ch < 3; ++ch) gs[ch] = clip_pass(p.s[ch], g_sky0[ch]);
                const int face = face_uv(p.d.x, p.d.y, p.d.z, u, v);
                const Lerp lerp = bilinear_lerp(sky, face, u, v);
                lerp_adjoint(sky, p.d.x, p.d.y, p.d.z, u, v, lerp, lerp_texels(sky, lerp), gs,
                             gdir);
                g_d = g_d + v3(gdir[0], gdir[1], gdir[2]);
            }
            const V3 g_rd = normalize_adjoint(p.rd, g_d);
            gc[0] = g_ro.x;
            gc[1] = g_ro.y;
            gc[2] = g_ro.z;
            gc[3] = p.cu * g_rd.x;
            gc[4] = p.cu * g_rd.y;
            gc[5] = p.cu * g_rd.z;
            gc[6] = p.cv * g_rd.x;
            gc[7] = p.cv * g_rd.y;
            gc[8] = p.cv * g_rd.z;
            gc[9] = -g_rd.x;
            gc[10] = -g_rd.y;
            gc[11] = -g_rd.z;
            gc[12] = rt::dot(g_rd, v3(s_cam[3], s_cam[4], s_cam[5])) * (p.u - 0.5f);
            gc[13] = rt::dot(g_rd, v3(s_cam[6], s_cam[7], s_cam[8])) * (p.v - 0.5f);
        }
    }
    // summed over the warp by object, then in shared memory; one pass of
    // global atomics a block, non-zero entries only
    if (g_scene != nullptr) {
        rt::route<6>(s_grad, geo, g_geo, 0);
        rt::route<9>(s_grad, mat, g_mat, 6);
    }
    if (g_cam != nullptr) rt::route<14>(s_gcam, inside ? 0 : -1, gc, 0);
    __syncthreads();
    if (g_scene != nullptr) {
        for (int i = tid; i < table; i += rt::THREADS) {
            const float s = s_grad[i];
            if (s != 0.0f) atomicAdd(&g_scene[i], s);
        }
    }
    if (g_cam != nullptr && tid < 16) {
        const float s = s_gcam[tid];
        if (s != 0.0f) atomicAdd(&g_cam[tid], s);
    }
}

// Opts a kernel in to `smem` bytes of dynamic shared memory where that is
// more than the default 48 KB.
template <class Kernel>
int soft_smem(Kernel kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
}
}  // namespace

// Launches the forward kernel over one sample of n = H*W pixels on `stream`:
// the bilinear arm where `bilinear` is not 0 (a sky larger than 1x1), else
// the nearest texel. planes: (10,H,W) float32; total_in: (H,W,3)
// float32 or null (the first sample); total_out: (H,W,3) float32, may be
// total_in; the sky: packed (6*sky_h*sky_w,) int32, or r, g, b float32 planes
// (the other null); state: (4, 5 or, bilinear, 7,H,W) int32 or null (no
// grad). Device pointers. Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int rt_sky_compose(const float* planes, const float* total_in, float* total_out,
                              const int* packed, const float* r, const float* g, const float* b,
                              int sky_h, int sky_w, int n, int bilinear, int* state,
                              void* stream) {
    if (n <= 0) return 0;
    const Sky sky{packed, r, g, b, sky_h, sky_w};
    const int blocks = (n + THREADS - 1) / THREADS;
    if (bilinear) {
        sky_compose_bilinear_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            planes, total_in, total_out, sky, n, state);
    } else {
        sky_compose_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            planes, total_in, total_out, sky, n, state);
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

// Launches the soft silhouettes' composite over one frame of width x height
// pixels (rows row0 .. of a norm_height-tall frame) on `stream`: result and
// out (H,W,3) float32, scene (n_objects,16) and cam (16,) float32, the sky as
// rt_sky_compose takes it (`bilinear`: its bilinear arm), temp the
// temperature. Returns the cudaError_t of the launch (0 = launched).
extern "C" int rt_soft_silhouettes(const float* result, const float* scene, const float* cam,
                                   const int* packed, const float* r, const float* g,
                                   const float* b, int sky_h, int sky_w, int bilinear,
                                   int n_objects, int width, int height, int norm_height,
                                   int row0, float temp, float* out, void* stream) {
    if (width <= 0 || height <= 0) return 0;
    const Sky sky{packed, r, g, b, sky_h, sky_w};
    const SoftFrame f{n_objects, width, height, norm_height, row0, temp, bilinear != 0};
    const size_t smem = (size_t)n_objects * rt::SCENE_COLS * sizeof(float);
    const int err = soft_smem(soft_silhouettes_kernel, smem);
    if (err != 0) return err;
    const dim3 block(rt::BLOCK_W, rt::BLOCK_H);
    const dim3 grid((width + rt::BLOCK_W - 1) / rt::BLOCK_W,
                    (height + rt::BLOCK_H - 1) / rt::BLOCK_H);
    soft_silhouettes_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(result, scene, cam, sky,
                                                                         f, out);
    return (int)cudaGetLastError();
}

// Launches the adjoint: g_out, result, g_result (H,W,3) float32 (g_result may
// be null), the scene, camera, sky and frame as the forward took them;
// g_scene (n_objects,16) and g_cam (16,) float32, zero at launch, or null
// where no cotangent is asked for. Returns the cudaError_t of the launch.
extern "C" int rt_soft_silhouettes_adjoint(const float* g_out, const float* result,
                                           const float* scene, const float* cam,
                                           const int* packed, const float* r, const float* g,
                                           const float* b, int sky_h, int sky_w, int bilinear,
                                           int n_objects, int width, int height, int norm_height,
                                           int row0, float temp, float* g_result,
                                           float* g_scene, float* g_cam, void* stream) {
    if (width <= 0 || height <= 0) return 0;
    const Sky sky{packed, r, g, b, sky_h, sky_w};
    const SoftFrame f{n_objects, width, height, norm_height, row0, temp, bilinear != 0};
    const size_t smem = 2 * (size_t)n_objects * rt::SCENE_COLS * sizeof(float);
    const int err = soft_smem(soft_silhouettes_adjoint_kernel, smem);
    if (err != 0) return err;
    const dim3 block(rt::BLOCK_W, rt::BLOCK_H);
    const dim3 grid((width + rt::BLOCK_W - 1) / rt::BLOCK_W,
                    (height + rt::BLOCK_H - 1) / rt::BLOCK_H);
    soft_silhouettes_adjoint_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
        g_out, result, scene, cam, sky, f, g_result, g_scene, g_cam);
    return (int)cudaGetLastError();
}

// Text of a cudaError_t, for the wrapper's exception.
extern "C" const char* rt_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
