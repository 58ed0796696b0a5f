// One sample's sky lookup, compose and running sum, and its adjoint, for
// NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package looks the sky up and composes each
// sample inside the jit of render_image_pallas (its kernels/megakernel.py),
// where XLA fuses the lookup, the compose and the sum into a few loops. The
// port ran the same math as plain PyTorch, some 110 launches a sample
// (ops/cubemap.py::sample_cubemap, kernels/megakernel.py::compose_sky), and
// under grad autograd kept 22 planes a pixel of that sample's intermediates.
// These two kernels are that math, one launch a sample each way.
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
// What bounds them on this card: bytes. The forward reads 40 bytes of planes,
// the running sum's 12 and a texel a pixel, and writes 12 (plus 16 of state
// under grad); the adjoint reads 12 + 16 and writes 40. No arithmetic to
// speak of. At 1280x960 that is 80-100 MB a launch, about 0.03 ms at
// 3.35 TB/s. The texel reads are the only ones not coalesced: neighbouring
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
// ((sky * c) * miss), then r + it, then the lower clip, then the upper one.

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
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        const float c = planes[(6 + ch) * N + i];
        const float x = planes[ch * N + i] + (s[ch] * c) * missf;
        float y = x < 0.f ? 0.f : x;
        y = y > 1.f ? 1.f : y;
        const size_t o = 3 * (size_t)i + ch;
        total_out[o] = total_in != nullptr ? total_in[o] + y : y;
        word |= clip_code(x) << (CLIP_SHIFT + 2 * ch);
        if (state != nullptr) state[(1 + ch) * N + i] = __float_as_int(c);
    }
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
    const float missf = (word & MISS_BIT) ? 1.f : 0.f;
    float t[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        const float g = g_total[3 * (size_t)i + ch];
        const int code = (word >> (CLIP_SHIFT + 2 * ch)) & 3;
        const float gx = code == CLIP_FULL ? g : (code == CLIP_HALF ? g * 0.5f : 0.f);
        const float c = __int_as_float(state[(1 + ch) * N + i]);
        g_planes[ch * N + i] = gx;
        g_planes[(3 + ch) * N + i] = 0.f;
        g_planes[(6 + ch) * N + i] = (gx * missf) * s[ch];
        t[ch] = gx * (s[ch] * c);
    }
    g_planes[9 * N + i] = (t[0] + t[1]) + t[2];
}

}  // namespace

// Launches the forward kernel over one sample of n = H*W pixels on `stream`.
// planes: (10,H,W) float32; total_in: (H,W,3) float32 or null (the first
// sample); total_out: (H,W,3) float32, may be total_in; the sky: packed
// (6*sky_h*sky_w,) int32, or r, g, b float32 planes (the other null);
// state: (4 or 5,H,W) int32 or null (no grad); cache_flat, cache_packed
// (H,W) int32 and cache_miss (H,W) bool, all three or none. Device
// pointers. Returns the cudaError_t of the launch (0 = launched).
extern "C" int rt_sky_compose(const float* planes, const float* total_in, float* total_out,
                              const int* packed, const float* r, const float* g, const float* b,
                              int sky_h, int sky_w, int n, int* state, int* cache_flat,
                              int* cache_packed, unsigned char* cache_miss, void* stream) {
    if (n <= 0) return 0;
    const Sky sky{packed, r, g, b, sky_h, sky_w};
    sky_compose_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
        planes, total_in, total_out, sky, n, state, cache_flat, cache_packed, cache_miss);
    return (int)cudaGetLastError();
}

// Launches the adjoint over one sample: g_total (H,W,3) float32, state as
// the forward wrote it, the same sky, g_planes (10,H,W) float32 (every plane
// written). Returns the cudaError_t of the launch.
extern "C" int rt_sky_compose_adjoint(const float* g_total, const int* state, const int* packed,
                                      const float* r, const float* g, const float* b, int sky_h,
                                      int sky_w, int n, float* g_planes, void* stream) {
    if (n <= 0) return 0;
    const Sky sky{packed, r, g, b, sky_h, sky_w};
    sky_compose_adjoint_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
        g_total, state, sky, n, g_planes);
    return (int)cudaGetLastError();
}

// Text of a cudaError_t, for the wrapper's exception.
extern "C" const char* rt_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
