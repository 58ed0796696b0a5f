// Forward path-tracing megakernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ray_tracing_tpu/kernels/megakernel.py::_fwd_kernel
// (launched by _run_fwd), in both of its modes: RECORD=false is the plain
// forward, RECORD=true also stores one int32 winner-index plane per trace
// call (the residuals a path-replaying backward pass starts from).
//
// What it computes, per pixel and per sample: screen coordinates (with the
// row offset of a row-slice render and optional sub-pixel jitter), the
// camera ray, and up to `bounces` rounds of {closest hit over the scene,
// next-event estimation with `ns` jittered shadow rays toward the light,
// Fresnel-Schlick, a stochastic specular/diffuse branch, emission}. It
// writes ten float planes: radiance r,g,b; the direction x,y,z with which
// the path left the scene; the path throughput r,g,b at that moment; and a
// 0/1 flag saying that it did leave. The caller looks the sky up with those
// and composes the pixel.
//
// What bounds it on this card: that depends on the scene. A pixel reads
// nothing from device memory but the shared scene table and writes 40 bytes
// (plus 4 bytes per recorded trace call). Where most paths leave the scene
// at once (three spheres under an open sky) the float work is so small that
// writing the planes is the bound; in an enclosed, lit scene every path
// bounces to the end and casts shadow rays, and float operations are the
// bound, by a wide margin over the bytes. In both cases the kernel as it
// stands is limited by neither: by divergence between paths that die at
// different bounces, by the integer work of the generator and by latency.
//
// What the design does about it:
//   * one thread per pixel, blocks of 32x8 pixels: the ten stores of a warp
//     are ten contiguous 128-byte rows, and neighbouring pixels follow
//     similar paths for the first bounces, which keeps warps coherent;
//   * the (N,16) scene table is staged once per block into dynamic shared
//     memory (64 KB at N=1024); all threads of a warp read the same row at
//     the same time, which shared memory serves as a broadcast;
//   * the object kind is read from column 15 at run time, so one binary
//     serves every scene, and every RenderConfig scalar is an argument;
//   * the loop over bounces ends when the path is dead (unless RECORD, which
//     keeps the plain version's masked lanes so the index planes agree);
//     that is safe because random numbers are keyed by slot (Philox4x32-10,
//     counter = global pixel and slot group), not consumed from a stream;
//   * the state of a path lives in registers for the whole loop: nothing
//     but the final planes ever reaches device memory.
//
// Numerics: the arithmetic follows the plain PyTorch version
// (kernels/megakernel.py::tile_physics, ops/intersect.py) operation by
// operation and in the same order, and the file is compiled with
// --fmad=false and without fast-math, so that a*b+c rounds twice as it does
// in PyTorch's separate kernels. Slab tests use comparisons and selects,
// never fmaxf/fminf: `b > a ? b : a` keeps the incumbent when the
// challenger is NaN (0*inf on a face plane), as the reference's C code does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <bool RECORD>
__global__ void __launch_bounds__(BLOCK_W * BLOCK_H)
fwd_kernel(const float* __restrict__ scene, const float* __restrict__ cam,
           float* __restrict__ planes, int* __restrict__ rec, Params p) {
    extern __shared__ float s_rows[];
    __shared__ float s_cam[16];

    const int tid = threadIdx.y * BLOCK_W + threadIdx.x;
    for (int i = tid; i < p.n_objects * SCENE_COLS; i += BLOCK_W * BLOCK_H) s_rows[i] = scene[i];
    if (tid < 16) s_cam[tid] = cam[tid];
    __syncthreads();

    const int x = blockIdx.x * BLOCK_W + threadIdx.x;
    const int y = blockIdx.y * BLOCK_H + threadIdx.y;
    if (x >= p.width || y >= p.height) return;  // ragged edge

    const size_t plane = (size_t)p.width * p.height;
    const size_t pix = (size_t)y * p.width + x;
    const float* rows = s_rows;
    const int n = p.n_objects;
    const bool has_light = p.light_index >= 0;
    const bool cube_biased = p.cube_biased != 0;

    Draws draws;
    draws.seed = (uint32_t)p.seed;
    draws.pixel = (uint32_t)(p.row0 + y) * (uint32_t)p.width + (uint32_t)x;
    draws.group = -1;

    // pixel -> screen coordinates with the reference's flips
    const int wm1 = p.width - 1 > 1 ? p.width - 1 : 1;
    const int hm1 = p.norm_height - 1 > 1 ? p.norm_height - 1 : 1;
    float u = 1.0f - (float)x / (float)wm1;
    float v = 1.0f - ((float)y + (float)p.row0) / (float)hm1;
    if (p.pixel_jitter) {
        u = u + (draws.uniform(0) - 0.5f) / (float)wm1;
        v = v + (draws.uniform(1) - 0.5f) / (float)hm1;
    }

    // camera ray; rd stays UNNORMALISED for shading
    V3 ub = v3(s_cam[3], s_cam[4], s_cam[5]);
    V3 vb = v3(s_cam[6], s_cam[7], s_cam[8]);
    V3 cw = v3(s_cam[9], s_cam[10], s_cam[11]);
    float cu = (u - 0.5f) * s_cam[12];
    float cv = (v - 0.5f) * s_cam[13];
    V3 rd = v3(cu * ub.x + cv * vb.x - cw.x, cu * ub.y + cv * vb.y - cw.y,
               cu * ub.z + cv * vb.z - cw.z);
    V3 ro = v3(s_cam[0], s_cam[1], s_cam[2]);

    V3 contrib = v3(1.0f, 1.0f, 1.0f);
    V3 result = v3(0.0f, 0.0f, 0.0f);
    bool alive = true;
    V3 sky_dir = v3(1.0f, 1.0f, 1.0f);
    V3 sky_contrib = v3(0.0f, 0.0f, 0.0f);
    bool died_miss = false;

    V3 light_origin = v3(0.0f, 0.0f, 0.0f);
    V3 light_emission = v3(0.0f, 0.0f, 0.0f);
    if (has_light) {
        const float* lrow = rows + p.light_index * SCENE_COLS;
        V3 p0 = v3(lrow[0], lrow[1], lrow[2]);
        light_origin = lrow[15] == TYPE_SPHERE
                           ? p0
                           : p0 + v3(lrow[3], lrow[4], lrow[5]) * 0.5f;
    }
    if (p.single_emissive >= 0) {
        const float* erow = rows + p.single_emissive * SCENE_COLS;
        light_emission = v3(erow[12], erow[13], erow[14]);
    }

    const int per_bounce = 3 * p.ns + 4;
    const int rec_per_bounce = 1 + p.ns;

    for (int b = 0; b < p.bounces; ++b) {
        if (!RECORD && !alive) break;
        const int base = 2 + b * per_bounce;

        V3 d = normalize(rd);
        Hit h = trace(rows, n, ro, rd);
        if (RECORD) rec[(size_t)(b * rec_per_bounce) * plane + pix] = h.obj;

        // miss: remember direction and throughput for the sky lookup
        bool miss_now = alive && !h.hit;
        sky_dir = sel(miss_now, d, sky_dir);
        sky_contrib = sel(miss_now, contrib, sky_contrib);
        died_miss = died_miss || miss_now;
        bool active = alive && h.hit;

        // next-event estimation toward the light
        V3 sampled_light = v3(0.0f, 0.0f, 0.0f);
        if (has_light) {
            V3 to_light = light_origin - h.point;
            V3 sum = v3(0.0f, 0.0f, 0.0f);
            float num = 0.0f;
            for (int s = 0; s < p.ns; ++s) {
                V3 rand_dir = draws.direction(base + 3 * s, cube_biased);
                bool accept = dot(rand_dir, h.normal) > 0.0f;
                int winner = -1;
                if (RECORD || (active && accept)) {
                    V3 sample_dir = normalize(rand_dir * p.shadow_spread + to_light);
                    V3 sample_ro = h.point + sample_dir * p.hit_offset;
                    winner = p.single_emissive >= 0
                                 ? shadow_occlusion(rows, n, p.single_emissive, sample_ro, sample_dir)
                                 : shadow_scan(rows, n, sample_ro, sample_dir);
                }
                if (RECORD) rec[(size_t)(b * rec_per_bounce + 1 + s) * plane + pix] = winner;
                if (accept) {
                    num += 1.0f;
                    if (winner >= 0) {
                        V3 e = p.single_emissive >= 0
                                   ? light_emission
                                   : v3(rows[winner * SCENE_COLS + 12], rows[winner * SCENE_COLS + 13],
                                        rows[winner * SCENE_COLS + 14]);
                        sum = sum + e;
                    }
                }
            }
            sampled_light = sum * (1.0f / (num > 1.0f ? num : 1.0f));
        }

        // Fresnel with the RAW incoming direction
        float nov = dot(h.normal, -rd);
        nov = nov < 0.0f ? 0.0f : (nov > 1.0f ? 1.0f : nov);
        float f0_d = 0.16f * h.reflectance * h.reflectance;
        float one_minus_m = 1.0f - h.metallic;
        V3 f0 = v3(f0_d * one_minus_m + h.albedo.x * h.metallic,
                   f0_d * one_minus_m + h.albedo.y * h.metallic,
                   f0_d * one_minus_m + h.albedo.z * h.metallic);
        float q = 1.0f - nov;
        float q2 = q * q;
        float p5 = q * (q2 * q2);
        V3 F = v3(f0.x + (1.0f - f0.x) * p5, f0.y + (1.0f - f0.y) * p5, f0.z + (1.0f - f0.z) * p5);

        V3 rand_dir = draws.direction(base + 3 * p.ns, cube_biased);
        if (dot(rand_dir, h.normal) < 0.0f) rand_dir = -rand_dir;

        // emission with the throughput from BEFORE the branch
        if (active) result = result + h.emission * contrib;

        float u_branch = draws.uniform(base + 3 * p.ns + 3);
        float f_avg = (F.x + F.y + F.z) / 3.0f;
        bool specular = (h.metallic > 0.001f) || (u_branch <= f_avg);
        V3 reflect_dir = rd - h.normal * (2.0f * dot(h.normal, rd));
        V3 out_spec = normalize(rand_dir * h.roughness + reflect_dir);
        V3 out_dir = sel(specular, out_spec, rand_dir);
        V3 contrib_new = sel(specular, contrib, contrib * h.albedo * one_minus_m);

        bool light_on = active && !is_zero(sampled_light);
        if (light_on) {
            result = result + sampled_light * contrib_new * p.light_weight;
            contrib_new = contrib_new * p.one_minus_light_weight;
        }

        if (active) {
            ro = h.point + out_dir * p.hit_offset;
            rd = out_dir;
            contrib = contrib_new;
        }
        alive = active;
    }

    planes[0 * plane + pix] = result.x;
    planes[1 * plane + pix] = result.y;
    planes[2 * plane + pix] = result.z;
    planes[3 * plane + pix] = sky_dir.x;
    planes[4 * plane + pix] = sky_dir.y;
    planes[5 * plane + pix] = sky_dir.z;
    planes[6 * plane + pix] = sky_contrib.x;
    planes[7 * plane + pix] = sky_contrib.y;
    planes[8 * plane + pix] = sky_contrib.z;
    planes[9 * plane + pix] = died_miss ? 1.0f : 0.0f;
}

}  // namespace

// Launches the forward kernel on `stream`. scene: (n_objects,16) float32,
// cam: 16 float32, planes: (10,height,width) float32, rec: (bounces*(1+ns),
// height,width) int32 or null (null selects the non-recording kernel); all
// device pointers. Returns the cudaError_t of the launch (0 = launched).
extern "C" int rt_megakernel_fwd(const float* scene, const float* cam, float* planes, int* rec,
                                 int n_objects, int width, int height, int norm_height, int row0,
                                 int seed, int light_index, int single_emissive, int bounces,
                                 int ns, int cube_biased, int pixel_jitter, float shadow_spread,
                                 float light_weight, float one_minus_light_weight,
                                 float hit_offset, void* stream) {
    Params p;
    p.n_objects = n_objects;
    p.width = width;
    p.height = height;
    p.norm_height = norm_height;
    p.row0 = row0;
    p.seed = seed;
    p.light_index = light_index;
    p.single_emissive = single_emissive;
    p.bounces = bounces;
    p.ns = ns;
    p.cube_biased = cube_biased;
    p.pixel_jitter = pixel_jitter;
    p.shadow_spread = shadow_spread;
    p.light_weight = light_weight;
    p.one_minus_light_weight = one_minus_light_weight;
    p.hit_offset = hit_offset;

    const size_t smem = (size_t)n_objects * SCENE_COLS * sizeof(float);
    dim3 block(BLOCK_W, BLOCK_H);
    dim3 grid((width + BLOCK_W - 1) / BLOCK_W, (height + BLOCK_H - 1) / BLOCK_H);
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (rec != nullptr) {
        err = cudaFuncSetAttribute(fwd_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        fwd_kernel<true><<<grid, block, smem, s>>>(scene, cam, planes, rec, p);
    } else {
        err = cudaFuncSetAttribute(fwd_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        fwd_kernel<false><<<grid, block, smem, s>>>(scene, cam, planes, rec, p);
    }
    return (int)cudaGetLastError();
}

// Text of a cudaError_t, for the wrapper's exception.
extern "C" const char* rt_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
