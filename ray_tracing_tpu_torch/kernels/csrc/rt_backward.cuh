// The backward path-tracing megakernel for NVIDIA Hopper (sm_90a), shared by
// the port's three backward kernels. They compute the same gradients and
// differ in one thing only: where the winner of a trace call (which object a
// ray hits, -1 for none) comes from. That source is the template argument
// `Winners`:
//
//   FetchWinners    megakernel_bwd.cu          K3, "fetch": the index planes
//                                              the recording forward wrote
//   RecordedWinners megakernel_bwd_retrace.cu  K4, "replay": traced once in
//                                              phase A, kept in the state
//                                              words
//   TracedWinners   megakernel_bwd_retrace.cu  K5, "direct": K4's, in an
//                                              instantiation of its own
//
// A Winners type has a constructor (const int* rec, size_t plane, size_t pix)
// (FetchWinners reads the planes at `rec` at its own width, int8 or int16),
// a constant TRACES (whether it traces, and so needs the trace table) and
// three device methods, each given the shared-memory tables (Tables of
// rt_device.cuh): primary(sc, p, b, ray, saved, t, axis), the winner of
// bounce b's closest-hit ray (built once by the caller) with its t and face
// axis, where `saved` is the winner the walk kept in the bounce's state word
// (-1 where there is none); shadow(sc, p, b, s, ro, rd), the winner of
// bounce b's shadow sample s, whose ray is (ro, rd) for a source that traces
// (in the sweep, where a full shadow scan asks for the targets of the
// samples taken, zero for one that does not); begin_sweep(), called once
// between the two phases below. Trace calls are numbered in the forward's
// order: b*(1+ns) for bounce b's primary ray, b*(1+ns)+1+s for its shadow
// sample s.
//
// What it computes: the vector-Jacobian product of the per-pixel estimator
// of megakernel_fwd.cu. Inputs are the scene table (N,16), the camera pack
// (16) and the ten cotangent planes of the forward's ten output planes.
// Outputs are the two sums over every pixel of the frame: the gradient with
// respect to the scene table (N,16) and to the camera pack (16). Which object
// a ray hits, which root or face, specular or diffuse, sample accepted or
// not: every decision is recomputed and detached, no gradient flows through a
// comparison; every continuous quantity (hit distance, point, normal,
// material, emission, throughput, the next ray) is differentiated. Shadow
// rays carry no gradient (occlusion is detached), so the light's position
// gets none through next-event estimation (its origin's gradient, which the
// JAX package's replay backward adds to the light's row, is identically
// zero and is not computed); the emission they return does.
//
// CUDA has no automatic differentiation: the adjoint below is written by
// hand. Per thread (= pixel) it runs in two phases.
//   A. Forward walk. Walk the path again: the winner of every trace call
//      comes from `Winners`, its hit is recomputed from its own row with the
//      functions the forward used (rt_device.cuh), the draws are regenerated
//      from (seed, pixel, slot). With the same operations in the same order
//      and no FMA contraction the walk arrives at the forward's values bit
//      for bit, so it takes the forward's decisions. The state at the entry
//      of each bounce (origin, direction, throughput: 9 floats) and a tenth
//      word, the bounce's two masks of shadow samples (accepted; accepted
//      and hit) and its primary winner, are kept in dynamic shared memory,
//      laid out
//      [bounce][word][thread] so that the 32 lanes of a warp touch 32
//      consecutive words (no bank conflict, nothing in local memory). The
//      launch keeps up to SAVED_BOUNCES of them, as many as fit beside the
//      scene and gradient tables; a deeper bounce is recomputed from the
//      last entry kept, so every `bounces` works.
//   B. Reverse sweep over the bounces the path was alive in, last to first,
//      carrying the adjoints of origin, direction and throughput. Each step
//      evaluates its bounce once, from its entry state and the walk's
//      masks: the shadow samples need no draw, no ray and, with a single
//      emitter, no winner (a full shadow scan asks `Winners` again for the
//      samples taken), so the step draws only the bounce direction and the
//      branch. Any number of shadow samples: the masks keep the first
//      MASK_BITS outcomes and a count of the samples taken; the routing of a
//      full scan draws and tests a sample past them again. The adjoint and
//      the routing of the shadow samples both read that evaluation. A path
//      that left the scene starts from the cotangents of the sky direction
//      and sky throughput planes; every
//      addition to the radiance takes the cotangent of the radiance planes.
//      A dead lane contributes exactly nothing: the walk stops where the
//      path died.
//
// Routing is part of the kernel: each bounce yields 15 gradient entries for
// the row of the object hit (column 15, the type tag, has none) and 3 for the
// emitting row of every shadow sample taken; the camera gets 14 per pixel.
// They are summed in shared memory (a second (N,16) table beside the scene
// table, and 16 floats for the camera), then each block adds its non-zero
// entries to the outputs with one pass of global atomics. In front of the
// shared atomics each warp reduces by key: __match_any_sync groups the lanes
// that hit the same object, a shuffle tree sums every group at once, and the
// lowest lane of each group adds its sums once. The outputs must be zero at
// launch. Float atomics add in an order that changes from run to run: the
// gradients are NOT bit-reproducible, only equal within rounding of a sum of
// that many terms.
//
// The sphere adjoint divides by the root of the discriminant. That root is
// never 0 here: the forward counts a sphere as hit only when its discriminant
// is strictly positive (rt_device.cuh, intersect_sphere), the walk recomputes
// the same bits, and only winners are differentiated. A grazing hit gives a
// large gradient, finite as in the plain versions.

#pragma once

#include "rt_device.cuh"

namespace rt {

// Shadow samples whose outcome Bounce keeps as a bit of its masks; the
// samples past them are drawn and tested again where the routing needs them.
constexpr int MASK_BITS = 32;

struct PathState {
    V3 ro, rd, contrib;
};

// The entry states in shared memory: [bounce][word][thread], nine floats
// and a tenth word, the state word (pack_word): the masks of the bounce's
// shadow samples while ns <= KNOWN_SAMPLES (the sweep evaluates the samples
// again above) and the bounce's primary winner. At most SAVED_BOUNCES of
// them: 100 KB for a block of 256 threads, so that two blocks stay resident
// on an SM; at 1024 objects the tables leave room for fewer (bwd_shape). A
// deeper bounce is walked to from the last one.
constexpr int STATE_FLOATS = 10;
constexpr int SAVED_BOUNCES = 10;
// The state word: accepted samples in bits [0, 10), accepted and hit in
// [10, 20), the primary winner in [20, 32). A saved bounce hit something, so
// its winner is an index below 4096; shared memory admits far fewer objects
// (bwd_shape: each takes at least its row and its gradient row, 128 bytes of
// the 227 KB).
constexpr int KNOWN_SAMPLES = 10;
constexpr unsigned KNOWN_MASK = (1u << KNOWN_SAMPLES) - 1u;
constexpr int WINNER_SHIFT = 2 * KNOWN_SAMPLES;

__device__ __forceinline__ void save_state(float* saved, int b, int tid, const PathState& st,
                                           unsigned word) {
    float* d = saved + (size_t)b * STATE_FLOATS * THREADS + tid;
    d[0 * THREADS] = st.ro.x;
    d[1 * THREADS] = st.ro.y;
    d[2 * THREADS] = st.ro.z;
    d[3 * THREADS] = st.rd.x;
    d[4 * THREADS] = st.rd.y;
    d[5 * THREADS] = st.rd.z;
    d[6 * THREADS] = st.contrib.x;
    d[7 * THREADS] = st.contrib.y;
    d[8 * THREADS] = st.contrib.z;
    d[9 * THREADS] = __uint_as_float(word);
}

__device__ __forceinline__ PathState load_state(const float* saved, int b, int tid,
                                                unsigned& word) {
    const float* d = saved + (size_t)b * STATE_FLOATS * THREADS + tid;
    word = __float_as_uint(d[9 * THREADS]);
    PathState st;
    st.ro = v3(d[0 * THREADS], d[1 * THREADS], d[2 * THREADS]);
    st.rd = v3(d[3 * THREADS], d[4 * THREADS], d[5 * THREADS]);
    st.contrib = v3(d[6 * THREADS], d[7 * THREADS], d[8 * THREADS]);
    return st;
}

// Everything one live bounce computes from its entry state, kept for the
// step forward and for the adjoint.
struct Bounce {
    int obj;       // primary winner, -1: the path leaves the scene here
    int axis;      // face axis of a box hit, -1 for a sphere
    Ray ray;
    float t;
    V3 point, normal;
    V3 albedo, emission;
    float roughness, metallic, one_minus_m;
    V3 rand_dir;   // bounce direction draw, flipped into the normal's hemisphere
    V3 v_spec;     // rand_dir * roughness + reflect_dir, before normalisation
    V3 out_dir;
    V3 contrib_new;      // throughput after the branch, before the light blend
    V3 sampled_light;
    float inv_num;       // 1 / max(accepted shadow samples, 1)
    unsigned accepted;   // bit s < MASK_BITS: shadow sample s was accepted
    unsigned taken;      // bit s < MASK_BITS: shadow sample s was accepted and hit an object
    int n_taken;         // shadow samples accepted that hit an object, all of them
    bool specular, light_on;
};

// The state word of a saved bounce (see KNOWN_SAMPLES).
__device__ __forceinline__ unsigned pack_word(const Bounce& e) {
    return (e.accepted & KNOWN_MASK) | ((e.taken & KNOWN_MASK) << KNOWN_SAMPLES) |
           ((unsigned)e.obj << WINNER_SHIFT);
}

// t and face axis of a winner known by its index, from its row.
__device__ __forceinline__ int winner_hit(const Tables& sc, const Ray& r, int obj, float& t,
                                          int& axis) {
    if (obj >= 0) t = intersect_row(r, sc.rows + obj * SCENE_COLS, axis);
    return obj;
}

__device__ __forceinline__ float comp(V3 v, int axis) {
    return axis == 0 ? v.x : (axis == 1 ? v.y : v.z);
}

__device__ __forceinline__ void add_comp(V3& v, int axis, float s) {
    if (axis == 0) v.x += s;
    else if (axis == 1) v.y += s;
    else v.z += s;
}

// Adjoint of normalize(v): g is the cotangent of the result. Below
// NORMALIZE_EPS the forward passes v through, and so does the adjoint.
__device__ __forceinline__ V3 normalize_adj(V3 v, V3 g) {
    float n = sqrtf(dot(v, v));
    if (n < NORMALIZE_EPS) return g;
    float inv = 1.0f / n;
    V3 u = v * inv;
    return (g - u * dot(u, g)) * inv;
}

// The winner of shadow sample s of bounce b (hit point e.point), asked of
// `win` in the sweep: the target of a full shadow scan's sample taken. The
// sample is drawn and its ray built only for a source that traces it.
template <class Winners>
__device__ __forceinline__ int taken_target(const Tables& sc, Winners& win, const Params& p,
                                            Draws& draws, const Bounce& e, V3 to_light, int b,
                                            int s) {
    V3 ro = v3(0.0f, 0.0f, 0.0f), rd = ro;
    if (Winners::TRACES) {
        const int base = 2 + b * (3 * p.ns + 4);
        shadow_ray(p, e.point, to_light, draws.direction(base + 3 * s, p.cube_biased != 0), ro,
                   rd);
    }
    return win.shadow(sc, p, b, s, ro, rd);
}

// Bounce b from its entry state: the forward kernel's operations in the
// forward kernel's order, the winners from `win`. The bounce's ray is built
// once and handed to the trace, whose winner comes back with its t and face.
// With `known` the caller has set e.accepted and e.taken from the walk: the
// shadow samples are then summed from the masks, in the same order, with no
// draw and no ray. `saved`: the primary winner the walk kept in the state
// word, -1 where there is none (the walk itself, a bounce deeper than the
// saved states).
template <class Winners>
__device__ __forceinline__ void eval_bounce(const Tables& sc, Winners& win, const Params& p,
                                            V3 light_origin, V3 light_emission, Draws& draws,
                                            const PathState& st, int b, Bounce& e, bool known,
                                            int saved) {
    const int base = 2 + b * (3 * p.ns + 4);
    const bool cube_biased = p.cube_biased != 0;
    const float* rows = sc.rows;

    e.ray = make_ray(st.ro, st.rd);
    e.obj = win.primary(sc, p, b, e.ray, saved, e.t, e.axis);
    if (e.obj < 0) return;

    const float* row = rows + e.obj * SCENE_COLS;
    e.point = e.ray.ro + e.ray.d * e.t;
    if (e.axis < 0) {
        e.normal = normalize(e.point - v3(row[0], row[1], row[2]));
    } else {
        e.normal = cube_normal(e.ray, e.axis);
    }
    e.albedo = v3(row[6], row[7], row[8]);
    e.roughness = row[9];
    float reflectance = row[10];
    e.metallic = row[11];
    e.emission = v3(row[12], row[13], row[14]);

    // next-event estimation: a sample counts when its direction is accepted
    e.sampled_light = v3(0.0f, 0.0f, 0.0f);
    e.inv_num = 1.0f;
    e.n_taken = 0;
    if (!known) {
        e.accepted = 0u;
        e.taken = 0u;
    }
    if (p.light_index >= 0 && known) {
        // the walk's masks (ns <= KNOWN_SAMPLES): the same additions in the
        // same order
        V3 to_light = light_origin - e.point;
        V3 sum = v3(0.0f, 0.0f, 0.0f);
        float num = 0.0f;
        for (int s = 0; s < p.ns; ++s) {
            if (!((e.accepted >> s) & 1u)) continue;
            num += 1.0f;
            if (!((e.taken >> s) & 1u)) continue;
            ++e.n_taken;
            V3 em = light_emission;
            if (p.single_emissive < 0) {
                const int w = taken_target(sc, win, p, draws, e, to_light, b, s);
                em = v3(rows[w * SCENE_COLS + 12], rows[w * SCENE_COLS + 13],
                        rows[w * SCENE_COLS + 14]);
            }
            sum = sum + em;
        }
        e.inv_num = 1.0f / (num > 1.0f ? num : 1.0f);
        e.sampled_light = sum * e.inv_num;
    } else if (p.light_index >= 0) {
        V3 to_light = light_origin - e.point;
        V3 sum = v3(0.0f, 0.0f, 0.0f);
        float num = 0.0f;
        for (int s = 0; s < p.ns; ++s) {
            V3 rand_dir = draws.direction(base + 3 * s, cube_biased);
            if (dot(rand_dir, e.normal) > 0.0f) {
                if (s < MASK_BITS) e.accepted |= 1u << s;
                num += 1.0f;
                V3 sro, sdir;
                shadow_ray(p, e.point, to_light, rand_dir, sro, sdir);
                int w = win.shadow(sc, p, b, s, sro, sdir);
                if (w >= 0) {
                    if (s < MASK_BITS) e.taken |= 1u << s;
                    ++e.n_taken;
                    V3 em = p.single_emissive >= 0
                                ? light_emission
                                : v3(rows[w * SCENE_COLS + 12], rows[w * SCENE_COLS + 13],
                                     rows[w * SCENE_COLS + 14]);
                    sum = sum + em;
                }
            }
        }
        e.inv_num = 1.0f / (num > 1.0f ? num : 1.0f);
        e.sampled_light = sum * e.inv_num;
    }

    // Fresnel with the RAW incoming direction: feeds the branch only
    float nov = dot(e.normal, -st.rd);
    nov = nov < 0.0f ? 0.0f : (nov > 1.0f ? 1.0f : nov);
    float f0_d = 0.16f * reflectance * reflectance;
    e.one_minus_m = 1.0f - e.metallic;
    V3 f0 = v3(f0_d * e.one_minus_m + e.albedo.x * e.metallic,
               f0_d * e.one_minus_m + e.albedo.y * e.metallic,
               f0_d * e.one_minus_m + e.albedo.z * e.metallic);
    float q = 1.0f - nov;
    float q2 = q * q;
    float p5 = q * (q2 * q2);
    V3 F = v3(f0.x + (1.0f - f0.x) * p5, f0.y + (1.0f - f0.y) * p5, f0.z + (1.0f - f0.z) * p5);

    e.rand_dir = draws.direction(base + 3 * p.ns, cube_biased);
    if (dot(e.rand_dir, e.normal) < 0.0f) e.rand_dir = -e.rand_dir;

    float u_branch = draws.uniform(base + 3 * p.ns + 3);
    float f_avg = (F.x + F.y + F.z) / 3.0f;
    e.specular = (e.metallic > 0.001f) || (u_branch <= f_avg);
    V3 reflect_dir = st.rd - e.normal * (2.0f * dot(e.normal, st.rd));
    e.v_spec = e.rand_dir * e.roughness + reflect_dir;
    V3 out_spec = normalize(e.v_spec);
    e.out_dir = sel(e.specular, out_spec, e.rand_dir);
    e.contrib_new = sel(e.specular, st.contrib, st.contrib * e.albedo * e.one_minus_m);
    e.light_on = !is_zero(e.sampled_light);
}

// The state at the entry of the next bounce; `result` gathers the radiance.
__device__ __forceinline__ void advance(const Params& p, const Bounce& e, PathState& st,
                                        V3& result) {
    result = result + e.emission * st.contrib;
    V3 contrib_new = e.contrib_new;
    if (e.light_on) {
        result = result + e.sampled_light * contrib_new * p.light_weight;
        contrib_new = contrib_new * p.one_minus_light_weight;
    }
    st.ro = e.point + e.out_dir * p.hit_offset;
    st.rd = e.out_dir;
    st.contrib = contrib_new;
}

// Adjoint of one live bounce. In: the entry state `st`, what eval_bounce made
// of it, the cotangent of the radiance `g_res` and the adjoints `a` of the
// exit state. Out: `a` becomes the adjoints of the entry state, g[0..14] the
// gradient of the hit object's row, a_sum the gradient of the emission of
// every shadow sample that was taken.
__device__ __forceinline__ void bounce_adjoint(const float* rows, const Params& p,
                                               const PathState& st, const Bounce& e, V3 g_res,
                                               PathState& a, float* g, V3& a_sum) {
    const float* row = rows + e.obj * SCENE_COLS;
    const V3 d = e.ray.d;

    // ro' = point + out_dir * hit_offset, rd' = out_dir
    V3 a_point = a.ro;
    V3 a_out = a.ro * p.hit_offset + a.rd;
    // the light blend: result += sampled_light * contrib_new * w,
    // contrib' = contrib_new * (1 - w)
    V3 a_cn = a.contrib;
    a_sum = v3(0.0f, 0.0f, 0.0f);
    if (e.light_on) {
        a_sum = g_res * e.contrib_new * p.light_weight * e.inv_num;
        a_cn = a.contrib * p.one_minus_light_weight + g_res * e.sampled_light * p.light_weight;
    }

    // contrib_new = specular ? contrib : contrib * albedo * (1 - metallic)
    V3 a_contrib;
    if (e.specular) {
        a_contrib = a_cn;
    } else {
        a_contrib = a_cn * e.albedo * e.one_minus_m;
        V3 a_albedo = a_cn * st.contrib * e.one_minus_m;
        g[6] = a_albedo.x;
        g[7] = a_albedo.y;
        g[8] = a_albedo.z;
        g[11] = -dot(a_cn, st.contrib * e.albedo);
    }

    // result += emission * contrib
    V3 a_emission = g_res * st.contrib;
    g[12] = a_emission.x;
    g[13] = a_emission.y;
    g[14] = a_emission.z;
    a_contrib = a_contrib + g_res * e.emission;

    // out_dir = specular ? normalize(rand_dir * roughness + reflect(rd, n)) : rand_dir
    V3 a_rd = v3(0.0f, 0.0f, 0.0f);
    V3 a_normal = v3(0.0f, 0.0f, 0.0f);
    if (e.specular) {
        V3 a_v = normalize_adj(e.v_spec, a_out);
        g[9] = dot(a_v, e.rand_dir);
        float an = dot(a_v, e.normal);
        float k = dot(e.normal, st.rd);
        a_rd = a_v - e.normal * (2.0f * an);
        a_normal = st.rd * (-2.0f * an) - a_v * (2.0f * k);
    }

    // sphere normal = normalize(point - center); a box's normal is constant
    V3 a_p0 = v3(0.0f, 0.0f, 0.0f);
    if (e.axis < 0) {
        V3 a_q = normalize_adj(e.point - v3(row[0], row[1], row[2]), a_normal);
        a_point = a_point + a_q;
        a_p0 = a_p0 - a_q;
    }

    // point = ro + d * t
    V3 a_ro = a_point;
    V3 a_d = a_point * e.t;
    float a_t = dot(a_point, d);

    if (e.axis < 0) {
        // t = (-b -+ sqrt(b^2 - 4 a c)) * (0.5 / a), b = -2 oc.d,
        // c = oc.oc - r^2, oc = center - ro; the root is a detached choice
        V3 oc = v3(row[0], row[1], row[2]) - e.ray.ro;
        float radius = row[3];
        float bq = -2.0f * dot(oc, d);
        float cq = dot(oc, oc) - radius * radius;
        float sq = sqrtf(bq * bq - 4.0f * e.ray.a * cq);
        float s0 = (-bq - sq) * e.ray.inv2a;
        float sign = s0 < 0.0f ? 1.0f : -1.0f;
        float a_bq = -a_t * e.ray.inv2a;
        float a_sq = sign * a_t * e.ray.inv2a;
        float a_inv2a = a_t * (-bq + sign * sq);
        float a_discr = a_sq * 0.5f / sq;  // sq > 0 on a winner: see the header
        a_bq += a_discr * 2.0f * bq;
        float a_cq = -4.0f * e.ray.a * a_discr;
        float a_a = -4.0f * cq * a_discr - a_inv2a * e.ray.inv2a / e.ray.a;
        V3 a_oc = d * (-2.0f * a_bq) + oc * (2.0f * a_cq);
        a_d = a_d + oc * (-2.0f * a_bq) + d * (2.0f * a_a);
        g[3] = -2.0f * radius * a_cq;
        a_p0 = a_p0 + a_oc;
        a_ro = a_ro - a_oc;
    } else {
        // t = (edge - ro) * (1/d) on the face's axis, edge = lo or lo + size;
        // detached on a ray parallel to the slab
        float d_ax = comp(d, e.axis);
        if (d_ax != 0.0f) {
            bool entering_lo = d_ax >= 0.0f;
            float inv = comp(e.ray.inv, e.axis);
            float edge = entering_lo ? row[e.axis] : row[e.axis] + row[3 + e.axis];
            float num = edge - comp(e.ray.ro, e.axis);
            float a_num = a_t * inv;
            add_comp(a_d, e.axis, -(a_t * num) * inv * inv);
            add_comp(a_ro, e.axis, -a_num);
            add_comp(a_p0, e.axis, a_num);
            if (!entering_lo) {  // the far edge is lo + size
                if (e.axis == 0) g[3] = a_num;
                else if (e.axis == 1) g[4] = a_num;
                else g[5] = a_num;
            }
        }
    }
    g[0] = a_p0.x;
    g[1] = a_p0.y;
    g[2] = a_p0.z;

    // d = normalize(rd)
    a_rd = a_rd + normalize_adj(st.rd, a_d);

    a.ro = a_ro;
    a.rd = a_rd;
    a.contrib = a_contrib;
}

// Sums vals[0..COUNT) over the lanes of the warp that share a key: after
// the call the lowest lane of each group of equal keys holds its group's
// sums in `vals` (the other lanes hold partial sums). Every lane of the warp
// must call it; returns whether this lane is its group's lowest. One shuffle
// tree serves every group at once: in round k each remaining lane adds the
// values of the next remaining lane of its group above it, then the lanes
// at odd rank (counted in that round) drop out; ceil(log2(largest group))
// rounds.
template <int COUNT>
__device__ __forceinline__ bool reduce_by_key(int key, float* vals) {
    const unsigned lane = threadIdx.x;
    const unsigned below = (1u << lane) - 1u;
    unsigned peers = __match_any_sync(FULL_MASK, key);
    const bool lowest = (peers & below) == 0u;
    unsigned rank = __popc(peers & below);
    peers &= ~((2u << lane) - 1u);  // the lanes of the group above this one
    while (__any_sync(FULL_MASK, peers != 0u)) {
        const int next = __ffs(peers);  // 1 + the next lane up, 0: none
#pragma unroll
        for (int c = 0; c < COUNT; ++c) {
            const float t = __shfl_sync(FULL_MASK, vals[c], (next - 1) & 31);
            if (next != 0) vals[c] += t;
        }
        peers &= ~__ballot_sync(FULL_MASK, (rank & 1u) != 0u);
        rank >>= 1;
    }
    return lowest;
}

// Adds vals[0..COUNT) to table[key*16 + first_col ...] in shared memory for
// every lane whose key is >= 0: reduced by key inside the warp first, so
// each distinct key of the warp makes one add per non-zero column. Every
// lane of the warp must call it; `vals` is overwritten.
template <int COUNT>
__device__ __forceinline__ void route(float* table, int key, float* vals, int first_col) {
    if (__ballot_sync(FULL_MASK, key >= 0) == 0u) return;
    if (reduce_by_key<COUNT>(key, vals) && key >= 0) {
#pragma unroll
        for (int c = 0; c < COUNT; ++c) {
            if (vals[c] != 0.0f) atomicAdd(&table[key * SCENE_COLS + first_col + c], vals[c]);
        }
    }
}

// Floats of the trace table a Winners source needs: none for one that
// traces nothing (Winners::TRACES false).
template <class Winners>
__host__ __device__ __forceinline__ int table_floats(int n, int n_sph) {
    return Winners::TRACES ? trace_table_floats(n, n_sph) : 0;
}

// `rec`: the index planes (read by FetchWinners only). `primal`, when not
// null, receives the ten planes the forward walk arrives at, to be held
// against the forward kernel's (a check, not used by training). `n_saved`:
// entry states kept in shared memory (launch_bwd sizes it).
template <class Winners>
__global__ void __launch_bounds__(THREADS)
bwd_kernel(const float* __restrict__ scene, const float* __restrict__ cam,
           const float* __restrict__ cot, const int* __restrict__ rec,
           float* __restrict__ g_scene, float* __restrict__ g_cam,
           float* __restrict__ primal, Params p, int n_saved) {
    // dynamic shared memory: the trace table, the scene rows, the gradient
    // table, the entry states
    extern __shared__ float4 s_dyn[];
    __shared__ float s_cam[16];
    __shared__ float s_gcam[16];
    const int table = p.n_objects * SCENE_COLS;
    float* s_table = reinterpret_cast<float*>(s_dyn);
    float* s_rows = s_table + table_floats<Winners>(p.n_objects, p.n_spheres);
    float* s_grad = s_rows + table;
    float* s_saved = s_grad + table;

    const int tid = threadIdx.y * BLOCK_W + threadIdx.x;
    for (int i = tid; i < table; i += THREADS) {
        s_rows[i] = scene[i];
        s_grad[i] = 0.0f;
    }
    if (tid < 16) {
        s_cam[tid] = cam[tid];
        s_gcam[tid] = 0.0f;
    }
    if (Winners::TRACES) {
        stage_trace_table(scene, p.n_objects, p.n_spheres, p.single_emissive, s_table);
    }
    __syncthreads();
    Tables sc;
    sc.tt = trace_table(s_table, p.n_objects, p.n_spheres);
    sc.rows = s_rows;

    const int x = blockIdx.x * BLOCK_W + threadIdx.x;
    const int y = blockIdx.y * BLOCK_H + threadIdx.y;
    // a thread past the ragged edge walks no path but takes part in its
    // warp's reductions
    const bool inside = x < p.width && y < p.height;

    const size_t plane = (size_t)p.width * p.height;
    const size_t pix = inside ? (size_t)y * p.width + x : 0;
    const float* rows = sc.rows;
    Winners win(rec, plane, pix);

    Draws draws;
    draws.seed = (uint32_t)p.seed;
    draws.pixel = (uint32_t)(p.row0 + y) * (uint32_t)p.width + (uint32_t)x;
    draws.group = -1;

    // pixel -> screen coordinates and the camera ray, as the forward has them
    const int wm1 = p.width - 1 > 1 ? p.width - 1 : 1;
    const int hm1 = p.norm_height - 1 > 1 ? p.norm_height - 1 : 1;
    float u = 1.0f - (float)x / (float)wm1;
    float v = 1.0f - ((float)y + (float)p.row0) / (float)hm1;
    if (p.pixel_jitter) {
        u = u + (draws.uniform(0) - 0.5f) / (float)wm1;
        v = v + (draws.uniform(1) - 0.5f) / (float)hm1;
    }
    V3 ub = v3(s_cam[3], s_cam[4], s_cam[5]);
    V3 vb = v3(s_cam[6], s_cam[7], s_cam[8]);
    V3 cw = v3(s_cam[9], s_cam[10], s_cam[11]);
    float cu = (u - 0.5f) * s_cam[12];
    float cv = (v - 0.5f) * s_cam[13];

    PathState st;
    st.rd = v3(cu * ub.x + cv * vb.x - cw.x, cu * ub.y + cv * vb.y - cw.y,
               cu * ub.z + cv * vb.z - cw.z);
    st.ro = v3(s_cam[0], s_cam[1], s_cam[2]);
    st.contrib = v3(1.0f, 1.0f, 1.0f);

    V3 light_origin = v3(0.0f, 0.0f, 0.0f);
    V3 light_emission = v3(0.0f, 0.0f, 0.0f);
    if (p.light_index >= 0) light_origin = light_origin_of(rows + p.light_index * SCENE_COLS);
    if (p.single_emissive >= 0) {
        const float* erow = rows + p.single_emissive * SCENE_COLS;
        light_emission = v3(erow[12], erow[13], erow[14]);
    }

    // ---- phase A: forward walk ---------------------------------------------
    Bounce e;
    V3 result = v3(0.0f, 0.0f, 0.0f);
    int n_live = 0;       // bounces the path was alive in and hit something
    bool missed = false;  // the path left the scene at bounce n_live
    if (inside) {
        for (int b = 0; b < p.bounces; ++b) {
            eval_bounce(sc, win, p, light_origin, light_emission, draws, st, b, e, false, -1);
            if (e.obj < 0) {
                missed = true;
                break;
            }
            if (b < n_saved) save_state(s_saved, b, tid, st, pack_word(e));
            advance(p, e, st, result);
            ++n_live;
        }
    }
    win.begin_sweep();

    if (primal != nullptr && inside) {
        V3 sky_dir = missed ? normalize(st.rd) : v3(1.0f, 1.0f, 1.0f);
        V3 sky_contrib = missed ? st.contrib : v3(0.0f, 0.0f, 0.0f);
        primal[0 * plane + pix] = result.x;
        primal[1 * plane + pix] = result.y;
        primal[2 * plane + pix] = result.z;
        primal[3 * plane + pix] = sky_dir.x;
        primal[4 * plane + pix] = sky_dir.y;
        primal[5 * plane + pix] = sky_dir.z;
        primal[6 * plane + pix] = sky_contrib.x;
        primal[7 * plane + pix] = sky_contrib.y;
        primal[8 * plane + pix] = sky_contrib.z;
        primal[9 * plane + pix] = missed ? 1.0f : 0.0f;
    }

    // ---- phase B: reverse sweep --------------------------------------------
    V3 g_res = v3(0.0f, 0.0f, 0.0f);
    PathState a;  // adjoints of the state at the entry of the bounce above
    a.ro = v3(0.0f, 0.0f, 0.0f);
    a.rd = v3(0.0f, 0.0f, 0.0f);
    a.contrib = v3(0.0f, 0.0f, 0.0f);
    if (inside) {
        g_res = v3(cot[0 * plane + pix], cot[1 * plane + pix], cot[2 * plane + pix]);
        if (missed) {
            // sky_dir = normalize(rd), sky_contrib = contrib at the miss
            V3 g_dir = v3(cot[3 * plane + pix], cot[4 * plane + pix], cot[5 * plane + pix]);
            a.rd = normalize_adj(st.rd, g_dir);
            a.contrib = v3(cot[6 * plane + pix], cot[7 * plane + pix], cot[8 * plane + pix]);
        }
    }

    // the sweep's length is the warp's longest path, so that every lane
    // reaches the warp-wide reductions of route()
    const int n_sweep = __reduce_max_sync(FULL_MASK, n_live);
    for (int b = n_sweep - 1; b >= 0; --b) {
        const bool on = b < n_live;
        float g[15];
#pragma unroll
        for (int c = 0; c < 15; ++c) g[c] = 0.0f;
        V3 a_sum = v3(0.0f, 0.0f, 0.0f);
        int key = -1;
        PathState entry;
        if (on) {
            // from bounce b's saved state, or, deeper than the saved states,
            // walking forward from the last one (one call site of
            // eval_bounce for both: the kernel's code stays smaller)
            const int first = b < n_saved ? b : n_saved - 1;
            unsigned word;
            entry = load_state(s_saved, first, tid, word);
            e.accepted = word & KNOWN_MASK;
            e.taken = (word >> KNOWN_SAMPLES) & KNOWN_MASK;
            const bool known = p.ns <= KNOWN_SAMPLES && first == b;
            V3 unused = v3(0.0f, 0.0f, 0.0f);
            for (int j = first;; ++j) {
                eval_bounce(sc, win, p, light_origin, light_emission, draws, entry, j, e, known,
                            j == first ? (int)(word >> WINNER_SHIFT) : -1);
                if (j == b) break;
                advance(p, e, entry, unused);
            }
            bounce_adjoint(rows, p, entry, e, g_res, a, g, a_sum);
            key = e.obj;
        }
        route<15>(s_grad, key, g, 0);

        // emission of the shadow samples taken, to the emitting row: from
        // the evaluation's masks and count, no draw and no ray made again
        // for the first MASK_BITS samples
        const bool lit = on && e.n_taken > 0 &&
                         (a_sum.x != 0.0f || a_sum.y != 0.0f || a_sum.z != 0.0f);
        if (__any_sync(FULL_MASK, lit)) {
            if (p.single_emissive >= 0) {
                // every target is the light: one add of a_sum per sample taken
                const float k = (float)(lit ? e.n_taken : 0);
                float ge[3] = {a_sum.x * k, a_sum.y * k, a_sum.z * k};
                route<3>(s_grad, lit ? p.single_emissive : -1, ge, 12);
            } else {
                const V3 to_light = light_origin - e.point;
                const int base = 2 + b * (3 * p.ns + 4);
                for (int s = 0; s < p.ns; ++s) {
                    int target = -1;
                    if (lit && s < MASK_BITS) {
                        if ((e.taken >> s) & 1u) {
                            target = taken_target(sc, win, p, draws, e, to_light, b, s);
                        }
                    } else if (lit && dot(draws.direction(base + 3 * s, p.cube_biased != 0),
                                          e.normal) > 0.0f) {
                        // past the masks: drawn and tested again; the
                        // winner of an accepted sample, -1 when it hit
                        // nothing, is its target
                        target = taken_target(sc, win, p, draws, e, to_light, b, s);
                    }
                    float ge[3] = {a_sum.x, a_sum.y, a_sum.z};
                    route<3>(s_grad, target, ge, 12);
                }
            }
        }
    }

    // the camera ray: ro = pos, rd = cu * ub + cv * vb - w,
    // cu = (u - 0.5) * screen_w, cv = (v - 0.5) * screen_h
    float gc[14];
    gc[0] = a.ro.x;
    gc[1] = a.ro.y;
    gc[2] = a.ro.z;
    gc[3] = cu * a.rd.x;
    gc[4] = cu * a.rd.y;
    gc[5] = cu * a.rd.z;
    gc[6] = cv * a.rd.x;
    gc[7] = cv * a.rd.y;
    gc[8] = cv * a.rd.z;
    gc[9] = -a.rd.x;
    gc[10] = -a.rd.y;
    gc[11] = -a.rd.z;
    gc[12] = dot(a.rd, ub) * (u - 0.5f);
    gc[13] = dot(a.rd, vb) * (v - 0.5f);
    route<14>(s_gcam, inside ? 0 : -1, gc, 0);

    // one pass of global atomics per block, non-zero entries only: a row no
    // pixel of this block hit costs nothing and stays exactly zero
    __syncthreads();
    for (int i = tid; i < table; i += THREADS) {
        float s = s_grad[i];
        if (s != 0.0f) atomicAdd(&g_scene[i], s);
    }
    if (tid < 16) {
        float s = s_gcam[tid];
        if (s != 0.0f) atomicAdd(&g_cam[tid], s);
    }
}

// How a launch of bwd_kernel<Winners> is shaped: its dynamic shared memory
// (the trace table, the scene rows, the gradient table and the entry
// states: one per bounce, at most SAVED_BOUNCES, and no more than fit in
// what the card lets one block opt in to) and the number of entry states
// kept. Returns a cudaError_t (0 = success); a scene whose tables leave no
// room for one state is refused.
template <class Winners>
int bwd_shape(int n_objects, int n_spheres, int bounces, size_t* smem, int* n_saved) {
    int device, optin;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, bwd_kernel<Winners>);
    if (err != cudaSuccess) return (int)err;
    const size_t tables = ((size_t)table_floats<Winners>(n_objects, n_spheres) +
                           2 * (size_t)n_objects * SCENE_COLS) * sizeof(float);
    const size_t state = (size_t)STATE_FLOATS * THREADS * sizeof(float);
    const size_t room = (size_t)optin - attr.sharedSizeBytes;
    const long fit = room > tables ? (long)((room - tables) / state) : 0;
    int keep = bounces < SAVED_BOUNCES ? bounces : SAVED_BOUNCES;
    if (fit < keep) keep = (int)fit;
    if (bounces > 0 && keep < 1) return (int)cudaErrorInvalidValue;
    *n_saved = keep;
    *smem = tables + (size_t)keep * state;
    return 0;
}

// Launches bwd_kernel<Winners> on `stream`; the arguments as the C entry
// points of megakernel_bwd.cu and megakernel_bwd_retrace.cu take them.
// Returns the cudaError_t of the launch (0 = launched).
template <class Winners>
int launch_bwd(const float* scene, const float* cam, const float* cot, const int* rec,
               float* g_scene, float* g_cam, float* primal, const Params& p, void* stream) {
    size_t smem;
    int n_saved;
    int err = bwd_shape<Winners>(p.n_objects, p.n_spheres, p.bounces, &smem, &n_saved);
    if (err != 0) return err;
    dim3 block(BLOCK_W, BLOCK_H);
    dim3 grid((p.width + BLOCK_W - 1) / BLOCK_W, (p.height + BLOCK_H - 1) / BLOCK_H);
    err = (int)cudaFuncSetAttribute(bwd_kernel<Winners>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != 0) return err;
    bwd_kernel<Winners><<<grid, block, smem, (cudaStream_t)stream>>>(scene, cam, cot, rec, g_scene,
                                                                      g_cam, primal, p, n_saved);
    return (int)cudaGetLastError();
}

// What a launch of bwd_kernel<Winners> at this scene's size and kinds and
// this depth takes:
// info[0] registers per thread, [1] local memory (stack) bytes per thread,
// [2] static and [3] dynamic shared memory bytes per block, [4] entry states
// kept in shared memory, [5] blocks resident per SM, [6] threads per block.
// Returns a cudaError_t (0 = success).
template <class Winners>
int bwd_info(int n_objects, int n_spheres, int bounces, int* info) {
    size_t smem;
    int n_saved;
    int err = bwd_shape<Winners>(n_objects, n_spheres, bounces, &smem, &n_saved);
    if (err != 0) return err;
    cudaFuncAttributes attr;
    err = (int)cudaFuncGetAttributes(&attr, bwd_kernel<Winners>);
    if (err != 0) return err;
    err = (int)cudaFuncSetAttribute(bwd_kernel<Winners>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != 0) return err;
    int blocks = 0;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bwd_kernel<Winners>, THREADS,
                                                             smem);
    if (err != 0) return err;
    info[0] = attr.numRegs;
    info[1] = (int)attr.localSizeBytes;
    info[2] = (int)attr.sharedSizeBytes;
    info[3] = (int)smem;
    info[4] = n_saved;
    info[5] = blocks;
    info[6] = THREADS;
    return 0;
}

}  // namespace rt
