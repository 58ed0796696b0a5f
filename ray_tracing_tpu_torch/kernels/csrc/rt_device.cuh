// Device code shared by the forward and the backward megakernel: vectors,
// the counter-based random numbers, the ray/sphere and ray/box tests and the
// launch parameters. Both kernels must walk the same paths, so the backward
// recomputes every hit with the very functions the forward found it with;
// nothing here may be changed in one operation or in their order without the
// forward losing its bit-equality with the plain PyTorch version
// (kernels/megakernel.py::tile_physics, ops/intersect.py, ops/sampling.py).
// Compile with --fmad=false and without fast-math.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr int BLOCK_W = 32;
constexpr int BLOCK_H = 8;
constexpr int SCENE_COLS = 16;
constexpr float BIG = 3.4e38f;
constexpr float HIT_THRESHOLD = 1e37f;
constexpr float NORMALIZE_EPS = 1e-5f;
constexpr float ZERO_EPS = 1e-4f;
constexpr float TYPE_SPHERE = 1.0f;
constexpr uint32_t STREAM_KEY = 0x52545443u;

struct V3 {
    float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 operator-(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 sel(bool m, V3 a, V3 b) { return m ? a : b; }

// Returns the vector unchanged when its length is below NORMALIZE_EPS.
__device__ __forceinline__ V3 normalize(V3 v) {
    float n = sqrtf(dot(v, v));
    bool small = n < NORMALIZE_EPS;
    float inv = 1.0f / (small ? 1.0f : n);
    return small ? v : v * inv;
}

__device__ __forceinline__ bool is_zero(V3 v) {
    return fabsf(v.x) < ZERO_EPS && fabsf(v.y) < ZERO_EPS && fabsf(v.z) < ZERO_EPS;
}

// ---------------------------------------------------------------------------
// Philox4x32-10, counter = (global pixel, slot / 4, 0, 0), key = (seed,
// STREAM_KEY), word = slot % 4. Slots are read in rising order, so the last
// group is kept and every group is computed at most once.
// ---------------------------------------------------------------------------

struct Draws {
    uint32_t seed;
    uint32_t pixel;
    int group;
    uint32_t w0, w1, w2, w3;

    __device__ __forceinline__ void compute(int g) {
        uint32_t c0 = pixel, c1 = (uint32_t)g, c2 = 0u, c3 = 0u;
        uint32_t k0 = seed, k1 = STREAM_KEY;
#pragma unroll
        for (int r = 0; r < 10; ++r) {
            uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
            uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
            uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
            c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
            k0 += 0x9E3779B9u;
            k1 += 0xBB67AE85u;
        }
        w0 = c0; w1 = c1; w2 = c2; w3 = c3;
        group = g;
    }

    // Uniform in [0,1): top 24 bits times 2^-24.
    __device__ __forceinline__ float uniform(int slot) {
        int g = slot >> 2;
        if (g != group) compute(g);
        int lane = slot & 3;
        uint32_t w = lane == 0 ? w0 : (lane == 1 ? w1 : (lane == 2 ? w2 : w3));
        return (float)(w >> 8) * (1.0f / 16777216.0f);
    }

    __device__ __forceinline__ V3 direction(int slot, bool cube_biased) {
        float ux = uniform(slot), uy = uniform(slot + 1), uz = uniform(slot + 2);
        if (cube_biased) {
            return normalize(v3(ux * 2.0f - 1.0f, uy * 2.0f - 1.0f, uz * 2.0f - 1.0f));
        }
        float z = ux * 2.0f - 1.0f;
        float phi = uy * 6.283185307179586f;
        float m = 1.0f - z * z;
        float r = sqrtf(m < 0.0f ? 0.0f : m);
        return v3(r * cosf(phi), r * sinf(phi), z);
    }
};

// ---------------------------------------------------------------------------
// Intersections
// ---------------------------------------------------------------------------

struct Ray {
    V3 ro, d, inv;   // origin, normalised direction, 1/d (signed inf on 0)
    float a, inv2a;  // d.d (not exactly 1) and 0.5/a
};

__device__ __forceinline__ Ray make_ray(V3 ro, V3 rd) {
    Ray r;
    r.ro = ro;
    r.d = normalize(rd);
    r.a = dot(r.d, r.d);
    r.inv2a = 0.5f / r.a;
    r.inv = v3(1.0f / r.d.x, 1.0f / r.d.y, 1.0f / r.d.z);
    return r;
}

// Sphere: strict discr > 0, nearest non-negative root; BIG on a miss.
__device__ __forceinline__ float intersect_sphere(const Ray& r, const float* row) {
    V3 oc = v3(row[0], row[1], row[2]) - r.ro;
    float radius = row[3];
    float b = -2.0f * dot(oc, r.d);
    float c = dot(oc, oc) - radius * radius;
    float discr = b * b - 4.0f * r.a * c;
    bool valid = discr > 0.0f;
    float sq = sqrtf(valid ? discr : 0.0f);
    float s0 = (-b - sq) * r.inv2a;
    float s1 = (-b + sq) * r.inv2a;
    float t = s0 < 0.0f ? s1 : s0;
    valid = valid && (t >= 0.0f);
    return valid ? t : BIG;
}

// Axis-aligned box by slabs, with the reference's axis bookkeeping. `axis`
// receives the face the ray enters through (0, 1, 2).
__device__ __forceinline__ float intersect_cube(const Ray& r, const float* row, int& axis) {
    V3 lo = v3(row[0], row[1], row[2]);
    V3 hi = v3(row[0] + row[3], row[1] + row[4], row[2] + row[5]);
    V3 ta = (lo - r.ro) * r.inv;
    V3 tb = (hi - r.ro) * r.inv;
    bool px = r.d.x >= 0.0f, py = r.d.y >= 0.0f, pz = r.d.z >= 0.0f;
    float tminx = px ? ta.x : tb.x, tmaxx = px ? tb.x : ta.x;
    float tminy = py ? ta.y : tb.y, tmaxy = py ? tb.y : ta.y;
    float tminz = pz ? ta.z : tb.z, tmaxz = pz ? tb.z : ta.z;

    bool miss = (tminx > tmaxy) || (tminy > tmaxx);
    bool y_tightens = tminy > tminx;
    float near = y_tightens ? tminy : tminx;
    float far = tmaxy < tmaxx ? tmaxy : tmaxx;
    miss = miss || (near > tmaxz) || (tminz > far);
    bool z_tightens = tminz > near;
    near = z_tightens ? tminz : near;
    axis = z_tightens ? 2 : (y_tightens ? 1 : 0);
    bool valid = !miss && (near >= 0.0f);
    return valid ? near : BIG;
}

__device__ __forceinline__ V3 cube_normal(const Ray& r, int axis) {
    float sx = r.d.x > 0.0f ? -1.0f : 1.0f;
    float sy = r.d.y > 0.0f ? -1.0f : 1.0f;
    float sz = r.d.z > 0.0f ? -1.0f : 1.0f;
    return v3(axis == 0 ? sx : 0.0f, axis == 1 ? sy : 0.0f, axis == 2 ? sz : 0.0f);
}

__device__ __forceinline__ float intersect_any(const Ray& r, const float* row, int& axis) {
    if (row[15] == TYPE_SPHERE) {
        axis = -1;
        return intersect_sphere(r, row);
    }
    return intersect_cube(r, row, axis);
}

// What every launch is told: the frame, the seed, the topology of the scene
// and the scalars of the render configuration.
struct Params {
    int n_objects;
    int width, height, norm_height, row0;
    int seed;
    int light_index;      // -1: no next-event estimation
    int single_emissive;  // index of the sole emitter, -1: full shadow scan
    int bounces, ns;      // ns: shadow samples per bounce (0 without a light)
    int cube_biased, pixel_jitter;
    float shadow_spread, light_weight, one_minus_light_weight, hit_offset;
};

}  // namespace rt

// The plain C entry points take the fields of Params one by one.
#define RT_PARAM_ARGS                                                                          \
    int n_objects, int width, int height, int norm_height, int row0, int seed, int light_index, \
        int single_emissive, int bounces, int ns, int cube_biased, int pixel_jitter,           \
        float shadow_spread, float light_weight, float one_minus_light_weight, float hit_offset

#define RT_FILL_PARAMS(p)                                  \
    rt::Params p;                                          \
    p.n_objects = n_objects;                               \
    p.width = width;                                       \
    p.height = height;                                     \
    p.norm_height = norm_height;                           \
    p.row0 = row0;                                         \
    p.seed = seed;                                         \
    p.light_index = light_index;                           \
    p.single_emissive = single_emissive;                   \
    p.bounces = bounces;                                   \
    p.ns = ns;                                             \
    p.cube_biased = cube_biased;                           \
    p.pixel_jitter = pixel_jitter;                         \
    p.shadow_spread = shadow_spread;                       \
    p.light_weight = light_weight;                         \
    p.one_minus_light_weight = one_minus_light_weight;     \
    p.hit_offset = hit_offset
