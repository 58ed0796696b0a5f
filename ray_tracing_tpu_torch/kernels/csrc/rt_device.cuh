// Device code shared by the forward and the backward megakernels: vectors,
// the counter-based random numbers, the ray/sphere and ray/box tests, the
// trace table, the closest-hit and shadow traces and the launch parameters. Every kernel must
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

// One group of four words. Out of line: inlined at every draw site it made
// the backward kernels some 15,000 SASS instructions long and pushed them
// into spills; called, every kernel measured faster (PERF.md, section 6).
__device__ __noinline__ uint4 philox_block(uint32_t seed, uint32_t pixel, int g) {
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
    return make_uint4(c0, c1, c2, c3);
}

struct Draws {
    uint32_t seed;
    uint32_t pixel;
    int group;
    uint32_t w0, w1, w2, w3;

    __device__ __forceinline__ void compute(int g) {
        const uint4 w = philox_block(seed, pixel, g);
        w0 = w.x;
        w1 = w.y;
        w2 = w.z;
        w3 = w.w;
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

// Sphere of centre c and squared radius r2: strict discr > 0, nearest
// non-negative root; BIG on a miss.
__device__ __forceinline__ float sphere_t(const Ray& r, V3 c, float r2) {
    V3 oc = c - r.ro;
    float b = -2.0f * dot(oc, r.d);
    float cq = dot(oc, oc) - r2;
    float discr = b * b - 4.0f * r.a * cq;
    bool valid = discr > 0.0f;
    float sq = sqrtf(valid ? discr : 0.0f);
    float s0 = (-b - sq) * r.inv2a;
    float s1 = (-b + sq) * r.inv2a;
    float t = s0 < 0.0f ? s1 : s0;
    valid = valid && (t >= 0.0f);
    return valid ? t : BIG;
}

// Axis-aligned box [lo, hi] by slabs, with the reference's axis bookkeeping.
// `axis` receives the face the ray enters through (0, 1, 2).
__device__ __forceinline__ float box_t(const Ray& r, V3 lo, V3 hi, int& axis) {
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

// One object from its scene row (the winner of a trace, found again): the
// same operations as the trace table's tests, so the same t bit for bit.
// `axis` is -1 for a sphere.
__device__ __forceinline__ float intersect_row(const Ray& r, const float* row, int& axis) {
    if (row[15] == TYPE_SPHERE) {
        axis = -1;
        float radius = row[3];
        return sphere_t(r, v3(row[0], row[1], row[2]), radius * radius);
    }
    return box_t(r, v3(row[0], row[1], row[2]),
                 v3(row[0] + row[3], row[1] + row[4], row[2] + row[5]), axis);
}

// "Does this sphere block the shadow ray before t_ref", sqrt-free (at_ref =
// a * t_ref): STRICT for an object after the light in index order, which
// must be strictly earlier; an object before it blocks on a tie too.
template <bool STRICT>
__device__ __forceinline__ bool sphere_occludes(const Ray& r, float4 s, float at_ref) {
    V3 oc = v3(s.x, s.y, s.z) - r.ro;
    float k = dot(oc, r.d);
    float c = dot(oc, oc) - s.w;
    float D = k * k - r.a * c;
    bool valid = D > 0.0f;
    float w = k - at_ref;
    float w2 = w * w;
    bool inside = (k < 0.0f) || (c < 0.0f);
    bool s1_fwd = (k >= 0.0f) || (c <= 0.0f);
    if (STRICT) {
        return valid && ((inside && (w < 0.0f) && (D < w2) && s1_fwd) ||
                         (!inside && ((w < 0.0f) || (D > w2))));
    }
    return valid && ((inside && (w <= 0.0f) && (D <= w2) && s1_fwd) ||
                     (!inside && ((w <= 0.0f) || (D >= w2))));
}

// ---------------------------------------------------------------------------
// The trace table: what the object loops read, staged once per block in
// shared memory beside the scene rows, spheres first, then boxes, each kind
// in index order, after a 16-byte header:
//   sphere k  float4 {centre.x, centre.y, centre.z, radius*radius}
//   box m     float4 {lo.x, lo.y, lo.z, hi.x}, float4 {hi.y, hi.z, index, 0}
//   then the spheres' indices (int), padded to 16 bytes
// with hi = lo + size. Both invariants are computed once, with the very
// operation the test made per ray before, so every t is the same bit for
// bit. One object is one or two broadcast 16-byte loads, and each loop runs
// over one kind: no per-object type branch. A closest hit breaks ties by
// index (spheres are scanned first, so a box wins a tie against a sphere of
// higher index), which picks the winner the in-order strict scan picks. The
// loops are not unrolled: by 2 or 4 they measured slower on the H100 (more
// registers, no gain in latency hiding; PERF.md, section 6).
// ---------------------------------------------------------------------------

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int THREADS = BLOCK_W * BLOCK_H;
static_assert(BLOCK_W == 32, "a warp is one row of the block: lane == threadIdx.x");

// floats of the trace table for n objects of which n_sph are spheres: a
// 16-byte header (the sole emitter's slot in its kind and its kind), the
// entries, the spheres' indices
__host__ __device__ __forceinline__ int trace_table_floats(int n, int n_sph) {
    return 4 + 4 * n_sph + 8 * (n - n_sph) + ((n_sph + 3) & ~3);
}

// A view of the staged table: its base and its two counts, every other
// offset derived where it is used, so that the view pins three registers
// for the life of the kernel.
struct TraceTable {
    const float* base;
    int n, n_sph;

    __device__ __forceinline__ int n_box() const { return n - n_sph; }
    __device__ __forceinline__ float4 sph(int k) const {
        return reinterpret_cast<const float4*>(base + 4)[k];
    }
    __device__ __forceinline__ const float4* box(int m) const {
        return reinterpret_cast<const float4*>(base + 4) + n_sph + 2 * m;
    }
    __device__ __forceinline__ int sph_obj(int k) const {
        return reinterpret_cast<const int*>(base + 4 + 4 * n_sph + 8 * n_box())[k];
    }
    // the sole emitter (Params::single_emissive): the spheres before it in
    // index order (its slot if it is one), and its kind
    __device__ __forceinline__ int li_sph() const { return reinterpret_cast<const int*>(base)[0]; }
    __device__ __forceinline__ bool li_is_sphere() const {
        return reinterpret_cast<const int*>(base)[1] != 0;
    }
};

// What the traces read: the scene rows (materials, the winner's row) and
// the trace table, both in shared memory.
struct Tables {
    const float* rows;
    TraceTable tt;
};

// Object i of the scene into the trace table; k: the spheres before it.
__device__ __forceinline__ void stage_object(const float* __restrict__ scene, int i, int k,
                                             bool is_sph, int emitter, int* head, float4* sph,
                                             float4* box, int* sph_obj) {
    const float* row = scene + (size_t)i * SCENE_COLS;
    if (is_sph) {
        const float radius = row[3];
        sph[k] = make_float4(row[0], row[1], row[2], radius * radius);
        sph_obj[k] = i;
    } else {
        const int m = i - k;
        box[2 * m] = make_float4(row[0], row[1], row[2], row[0] + row[3]);
        box[2 * m + 1] = make_float4(row[1] + row[4], row[2] + row[5], __int_as_float(i), 0.0f);
    }
    if (i == emitter) {
        head[0] = k;
        head[1] = is_sph ? 1 : 0;
    }
}

// Every thread of the block calls this: writes the trace table of the scene
// (global memory, n rows, n_sph spheres; `emitter`: the sole emitter or -1)
// into `dst`, 16-byte aligned, trace_table_floats(n, n_sph) floats. The
// table may be read (trace_table) after the caller's next __syncthreads. A
// scene of at most 32 objects is staged by the first warp alone, with no
// barrier of its own; a larger one in chunks of a block, each counting its
// spheres across the warps.
__device__ __forceinline__ void stage_trace_table(const float* __restrict__ scene, int n,
                                                  int n_sph, int emitter, float* dst) {
    int* head = reinterpret_cast<int*>(dst);
    float4* sph = reinterpret_cast<float4*>(dst + 4);
    float4* box = sph + n_sph;
    int* sph_obj = reinterpret_cast<int*>(box + 2 * (n - n_sph));
    const int lane = threadIdx.x, warp = threadIdx.y;
    const unsigned below = (1u << lane) - 1u;
    if (n <= BLOCK_W) {
        if (warp == 0) {
            const bool is_sph = lane < n && scene[(size_t)lane * SCENE_COLS + 15] == TYPE_SPHERE;
            const int k = __popc(__ballot_sync(FULL_MASK, is_sph) & below);
            if (lane < n) stage_object(scene, lane, k, is_sph, emitter, head, sph, box, sph_obj);
        }
        return;
    }
    __shared__ int s_count[BLOCK_H];
    int before = 0;  // spheres in the chunks already staged
    for (int c = 0; c < n; c += THREADS) {
        const int i = c + warp * BLOCK_W + lane;
        const bool is_sph = i < n && scene[(size_t)i * SCENE_COLS + 15] == TYPE_SPHERE;
        const unsigned ballot = __ballot_sync(FULL_MASK, is_sph);
        if (lane == 0) s_count[warp] = __popc(ballot);
        __syncthreads();
        int k = before + __popc(ballot & below);  // spheres before i
        int chunk = 0;
        for (int w = 0; w < BLOCK_H; ++w) {
            const int cw = s_count[w];
            if (w < warp) k += cw;
            chunk += cw;
        }
        if (i < n) stage_object(scene, i, k, is_sph, emitter, head, sph, box, sph_obj);
        before += chunk;
        __syncthreads();  // s_count is read before the next chunk writes it
    }
}

// The trace table staged at `table` (read after the barrier that follows
// stage_trace_table).
__device__ __forceinline__ TraceTable trace_table(const float* table, int n, int n_sph) {
    TraceTable tt;
    tt.base = table;
    tt.n = n;
    tt.n_sph = n_sph;
    return tt;
}

__device__ __forceinline__ float table_sphere_t(const Ray& r, float4 s) {
    return sphere_t(r, v3(s.x, s.y, s.z), s.w);
}

__device__ __forceinline__ float table_box_t(const Ray& r, const float4* b, int& axis) {
    const float4 b0 = b[0], b1 = b[1];
    return box_t(r, v3(b0.x, b0.y, b0.z), v3(b0.w, b1.x, b1.y), axis);
}

// Closest hit over the table: t (BIG on a miss), the winner's index (-1) and
// the face axis of a box winner (-1 for a sphere). The first object of equal
// t in index order wins.
__device__ __forceinline__ int closest(const TraceTable& tt, const Ray& r, float& t_best,
                                      int& axis_best) {
    t_best = BIG;
    axis_best = -1;
    int k_best = -1;
    for (int k = 0; k < tt.n_sph; ++k) {
        const float t = table_sphere_t(r, tt.sph(k));
        if (t < t_best) {
            t_best = t;
            k_best = k;
        }
    }
    int obj = k_best >= 0 ? tt.sph_obj(k_best) : -1;
    for (int m = 0; m < tt.n_box(); ++m) {
        const float4* b = tt.box(m);
        int axis;
        const float t = table_box_t(r, b, axis);
        const int i = __float_as_int(b[1].z);
        if (t < t_best || (t == t_best && i < obj)) {
            t_best = t;
            obj = i;
            axis_best = axis;
        }
    }
    return obj;
}

struct Hit {
    bool hit;
    int obj;
    V3 point, normal, albedo, emission;
    float roughness, reflectance, metallic;
};

// Closest hit with the material of the winner fetched from its row
// afterwards; all zeros on a miss.
__device__ __forceinline__ Hit trace(const Tables& sc, const Ray& r) {
    float t_best;
    int axis_best;
    const int obj = closest(sc.tt, r, t_best, axis_best);
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
    const float* row = sc.rows + obj * SCENE_COLS;
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
// then ask every other object whether it blocks the ray earlier; an object
// before the light in index order blocks on a tie too. Returns the winner:
// li or -1.
__device__ __forceinline__ int shadow_occlusion(const TraceTable& tt, int li, const Ray& r) {
    int axis;
    const int li_sph = tt.li_sph(), li_box = li - li_sph;
    const bool li_is_sphere = tt.li_is_sphere();
    const float t_e = li_is_sphere ? table_sphere_t(r, tt.sph(li_sph))
                                   : table_box_t(r, tt.box(li_box), axis);
    if (!(t_e < HIT_THRESHOLD)) return -1;
    const float at_ref = r.a * t_e;
    for (int k = 0; k < li_sph; ++k) {
        if (sphere_occludes<false>(r, tt.sph(k), at_ref)) return -1;
    }
    for (int k = li_sph + (li_is_sphere ? 1 : 0); k < tt.n_sph; ++k) {
        if (sphere_occludes<true>(r, tt.sph(k), at_ref)) return -1;
    }
    for (int m = 0; m < li_box; ++m) {
        if (table_box_t(r, tt.box(m), axis) <= t_e) return -1;
    }
    for (int m = li_box + (li_is_sphere ? 0 : 1); m < tt.n_box(); ++m) {
        if (table_box_t(r, tt.box(m), axis) < t_e) return -1;
    }
    return li;
}

// Full shadow scan: index of the nearest object, -1 when nothing is hit.
__device__ __forceinline__ int shadow_scan(const TraceTable& tt, const Ray& r) {
    float t_best;
    int axis;
    const int obj = closest(tt, r, t_best, axis);
    return t_best < HIT_THRESHOLD ? obj : -1;
}

// What every launch is told: the frame, the seed, the topology of the scene
// and the scalars of the render configuration.
struct Params {
    int n_objects;
    int n_spheres;        // objects whose type tag (column 15) is TYPE_SPHERE
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
__device__ __forceinline__ int shadow_winner(const Tables& sc, const Params& p, V3 ro, V3 rd) {
    const Ray r = make_ray(ro, rd);
    return p.single_emissive >= 0 ? shadow_occlusion(sc.tt, p.single_emissive, r)
                                  : shadow_scan(sc.tt, r);
}

}  // namespace rt

// The plain C entry points take the fields of Params one by one.
#define RT_PARAM_ARGS                                                                      \
    int n_objects, int n_spheres, int width, int height, int norm_height, int row0, int seed, \
        int light_index, int single_emissive, int bounces, int ns, int cube_biased,           \
        int pixel_jitter, float shadow_spread, float light_weight,                            \
        float one_minus_light_weight, float hit_offset

#define RT_FILL_PARAMS(p)                                  \
    rt::Params p;                                          \
    p.n_objects = n_objects;                               \
    p.n_spheres = n_spheres;                               \
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
