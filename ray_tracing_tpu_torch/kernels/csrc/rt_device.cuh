// Device code shared by the forward and the backward megakernels: vectors,
// the counter-based random numbers, the ray/sphere and ray/box tests, the
// closest-hit and shadow traces and the launch parameters. Every kernel must
// walk the same paths, so the backward kernels recompute every hit with the
// very functions the forward found it with;
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
// STREAM_KEY), word = slot % 4. The last group is kept: a bounce reads its
// 3*ns + 4 slots in rising order, so each of its groups is computed once
// (four at ns = 3); a slot read out of order recomputes its group.
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

// ---------------------------------------------------------------------------
// Closest hit and shadow traces over the scene table
// ---------------------------------------------------------------------------

// Sqrt-free "does this sphere block the shadow ray before t_ref": both
// strictness variants from one setup (at_ref = a * t_ref).
__device__ __forceinline__ bool occlude_sphere(const Ray& r, const float* row, float at_ref,
                                               bool want_strict) {
    V3 oc = v3(row[0], row[1], row[2]) - r.ro;
    float radius = row[3];
    float k = dot(oc, r.d);
    float c = dot(oc, oc) - radius * radius;
    float D = k * k - r.a * c;
    bool valid = D > 0.0f;
    float w = k - at_ref;
    float w2 = w * w;
    bool inside = (k < 0.0f) || (c < 0.0f);
    bool s1_fwd = (k >= 0.0f) || (c <= 0.0f);
    bool strict = valid && ((inside && (w < 0.0f) && (D < w2) && s1_fwd) ||
                            (!inside && ((w < 0.0f) || (D > w2))));
    bool nonstrict = valid && ((inside && (w <= 0.0f) && (D <= w2) && s1_fwd) ||
                               (!inside && ((w <= 0.0f) || (D >= w2))));
    return want_strict ? strict : nonstrict;
}

struct Hit {
    bool hit;
    int obj;
    V3 point, normal, albedo, emission;
    float roughness, reflectance, metallic;
};

// Closest hit: strictly-less-than scan (first of equal t wins), material of
// the winner fetched from its row afterwards; all zeros on a miss.
__device__ __forceinline__ Hit trace(const float* rows, int n, V3 ro, V3 rd) {
    Ray r = make_ray(ro, rd);
    float t_best = BIG;
    int obj = -1;
    int axis_best = -1;
    for (int i = 0; i < n; ++i) {
        int axis;
        float t = intersect_any(r, rows + i * SCENE_COLS, axis);
        if (t < t_best) {
            t_best = t;
            obj = i;
            axis_best = axis;
        }
    }
    Hit h;
    h.hit = t_best < HIT_THRESHOLD;
    h.obj = obj;
    float t_pt = h.hit ? t_best : 0.0f;
    h.point = r.ro + r.d * t_pt;
    if (obj < 0) {
        h.normal = v3(0.0f, 0.0f, 0.0f);
        h.albedo = v3(0.0f, 0.0f, 0.0f);
        h.emission = v3(0.0f, 0.0f, 0.0f);
        h.roughness = 0.0f;
        h.reflectance = 0.0f;
        h.metallic = 0.0f;
        return h;
    }
    const float* row = rows + obj * SCENE_COLS;
    if (axis_best < 0) {
        h.normal = normalize(h.point - v3(row[0], row[1], row[2]));
    } else {
        h.normal = cube_normal(r, axis_best);
    }
    h.albedo = v3(row[6], row[7], row[8]);
    h.roughness = row[9];
    h.reflectance = row[10];
    h.metallic = row[11];
    h.emission = v3(row[12], row[13], row[14]);
    return h;
}

// Shadow trace for scenes with exactly one emitter `li`: intersect the light,
// then ask every other object whether it blocks the ray earlier (ties go to
// the lower index). Returns the winner index: li or -1.
__device__ __forceinline__ int shadow_occlusion(const float* rows, int n, int li, V3 ro, V3 rd) {
    Ray r = make_ray(ro, rd);
    int axis;
    float t_e = intersect_any(r, rows + li * SCENE_COLS, axis);
    if (!(t_e < HIT_THRESHOLD)) return -1;
    float at_ref = r.a * t_e;
    for (int j = 0; j < n; ++j) {
        if (j == li) continue;
        const float* row = rows + j * SCENE_COLS;
        bool strict = j > li;
        bool occ;
        if (row[15] == TYPE_SPHERE) {
            occ = occlude_sphere(r, row, at_ref, strict);
        } else {
            float t_j = intersect_cube(r, row, axis);
            occ = strict ? (t_j < t_e) : (t_j <= t_e);
        }
        if (occ) return -1;
    }
    return li;
}

// Full shadow scan: index of the nearest object, -1 when nothing is hit.
__device__ __forceinline__ int shadow_scan(const float* rows, int n, V3 ro, V3 rd) {
    Ray r = make_ray(ro, rd);
    float t_best = BIG;
    int obj = -1;
    for (int i = 0; i < n; ++i) {
        int axis;
        float t = intersect_any(r, rows + i * SCENE_COLS, axis);
        if (t < t_best) {
            t_best = t;
            obj = i;
        }
    }
    return t_best < HIT_THRESHOLD ? obj : -1;
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

// Where next-event estimation aims: a sphere light's centre, a box light's
// origin plus half its size.
__device__ __forceinline__ V3 light_origin_of(const float* lrow) {
    V3 p0 = v3(lrow[0], lrow[1], lrow[2]);
    return lrow[15] == TYPE_SPHERE ? p0 : p0 + v3(lrow[3], lrow[4], lrow[5]) * 0.5f;
}

// The shadow ray of one sample from a hit point: the jittered direction
// toward the light and the origin pushed off the surface along it.
__device__ __forceinline__ void shadow_ray(const Params& p, V3 point, V3 to_light, V3 rand_dir,
                                           V3& ro, V3& dir) {
    dir = normalize(rand_dir * p.shadow_spread + to_light);
    ro = point + dir * p.hit_offset;
}

// Winner of a shadow ray: the occlusion-only trace toward the sole emitter,
// else the full scan.
__device__ __forceinline__ int shadow_winner(const float* rows, const Params& p, V3 ro, V3 rd) {
    return p.single_emissive >= 0 ? shadow_occlusion(rows, p.n_objects, p.single_emissive, ro, rd)
                                  : shadow_scan(rows, p.n_objects, ro, rd);
}

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
