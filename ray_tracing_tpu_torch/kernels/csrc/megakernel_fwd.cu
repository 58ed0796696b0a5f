// Forward path-tracing megakernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ray_tracing_tpu/kernels/megakernel.py::_fwd_kernel
// (launched by _run_fwd), in both of its modes: RECORD=false is the plain
// forward, RECORD=true also stores one winner-index plane per trace call
// (the residuals a path-replaying backward pass starts from), of the
// narrowest integer that holds the scene's object indices: int8 up to 127
// objects, int16 above (kernels/megakernel.py::record_dtype).
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
// (plus 1 or 2 bytes per recorded trace call). Where most paths leave the
// scene at once (three spheres under an open sky) the float work is so small
// that writing the planes is the bound; in an enclosed, lit scene every path
// bounces to the end and casts shadow rays, and float operations are the
// bound, by a wide margin over the bytes. In both cases the kernel as it
// stands is limited by neither: by divergence between paths that die at
// different bounces, by the integer work of the generator and by latency
// (storing the index planes at one byte instead of four left the recording
// kernel's time on three spheres unchanged, PERF.md section 6).
//
// What the design does about it:
//   * one thread per pixel, blocks of 32x8 pixels: the ten stores of a warp
//     are ten contiguous 128-byte rows, and neighbouring pixels follow
//     similar paths for the first bounces, which keeps warps coherent;
//   * the (N,16) scene table is staged once per block into dynamic shared
//     memory (64 KB at N=1024), and beside it the trace table the object
//     loops read (rt_device.cuh, TraceTable: one 16-byte entry per sphere,
//     two per box, each kind in a loop of its own, radius*radius and
//     lo + size computed once per block); all threads of a warp read the
//     same entry at the same time, which shared memory serves as a
//     broadcast 16-byte load;
//   * the object kinds are read from column 15 at run time, so one binary
//     serves every scene, and every RenderConfig scalar is an argument;
//   * three blocks (24 warps) per SM, at 80 registers a thread, to hide
//     the latency of the trace loops' dependent chains;
//   * the loop over bounces ends when the path is dead; that is safe because
//     random numbers are keyed by slot (Philox4x32-10, counter = global
//     pixel and slot group), not consumed from a stream. With RECORD the
//     index planes follow the dead-lane rule (kernels/megakernel.py,
//     record_layout): the bounce where the path misses stores -1 for its
//     shadow samples without tracing them, and a dead path stores -1 in
//     every entry of the bounces left before it leaves the loop (a warp is
//     one row of 32 pixels, so these stores are coalesced). A live bounce
//     traces every shadow sample when recording, rejected ones included:
//     its entries stay those of the plain recorder;
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

#include "rt_device.cuh"

using namespace rt;

namespace {

// Blocks kept resident per SM: 3 caps a thread at 80 registers (24 warps per
// SM; at 2 it took 105). ptxas then spills a few bytes, and the kernel is
// still faster (PERF.md, section 6).
constexpr int FWD_MIN_BLOCKS = 3;

// The kernel's body over index planes of type Index (int8_t or int16_t);
// the entries stored are the same integers at either width, -1 included.
template <bool RECORD, class Index>
__device__ __forceinline__ void fwd_body(const float* __restrict__ scene,
                                         const float* __restrict__ cam,
                                         float* __restrict__ planes, Index* __restrict__ rec,
                                         Params p) {
    // dynamic shared memory: the trace table, then the scene rows
    extern __shared__ float4 s_dyn[];
    __shared__ float s_cam[16];

    const int tid = threadIdx.y * BLOCK_W + threadIdx.x;
    float* s_table = reinterpret_cast<float*>(s_dyn);
    float* s_rows = s_table + trace_table_floats(p.n_objects, p.n_spheres);
    for (int i = tid; i < p.n_objects * SCENE_COLS; i += THREADS) s_rows[i] = scene[i];
    if (tid < 16) s_cam[tid] = cam[tid];
    stage_trace_table(scene, p.n_objects, p.n_spheres, p.single_emissive, s_table);
    __syncthreads();
    Tables sc;
    sc.tt = trace_table(s_table, p.n_objects, p.n_spheres);
    sc.rows = s_rows;

    const int x = blockIdx.x * BLOCK_W + threadIdx.x;
    const int y = blockIdx.y * BLOCK_H + threadIdx.y;
    if (x >= p.width || y >= p.height) return;  // ragged edge

    const size_t plane = (size_t)p.width * p.height;
    const size_t pix = (size_t)y * p.width + x;
    const float* rows = s_rows;
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
    if (has_light) light_origin = light_origin_of(rows + p.light_index * SCENE_COLS);
    if (p.single_emissive >= 0) {
        const float* erow = rows + p.single_emissive * SCENE_COLS;
        light_emission = v3(erow[12], erow[13], erow[14]);
    }

    const int per_bounce = 3 * p.ns + 4;
    const int rec_per_bounce = 1 + p.ns;

    for (int b = 0; b < p.bounces; ++b) {
        if (!alive) {
            if (RECORD) {
                for (int k = b * rec_per_bounce; k < p.bounces * rec_per_bounce; ++k) {
                    rec[(size_t)k * plane + pix] = (Index)-1;
                }
            }
            break;
        }
        const int base = 2 + b * per_bounce;

        const Ray ray = make_ray(ro, rd);
        const V3 d = ray.d;
        Hit h = trace(sc, ray);
        if (RECORD) rec[(size_t)(b * rec_per_bounce) * plane + pix] = (Index)h.obj;

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
                if (active && (RECORD || accept)) {
                    V3 sample_ro, sample_dir;
                    shadow_ray(p, h.point, to_light, rand_dir, sample_ro, sample_dir);
                    winner = shadow_winner(sc, p, sample_ro, sample_dir);
                }
                if (RECORD) rec[(size_t)(b * rec_per_bounce + 1 + s) * plane + pix] = (Index)winner;
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

// The kernel: one overload a width of the index planes, both named
// fwd_kernel<RECORD>. K1 (RECORD false) stores no plane and is the int8_t
// overload's.
template <bool RECORD>
__global__ void __launch_bounds__(THREADS, FWD_MIN_BLOCKS)
fwd_kernel(const float* __restrict__ scene, const float* __restrict__ cam,
           float* __restrict__ planes, int8_t* __restrict__ rec, Params p) {
    fwd_body<RECORD>(scene, cam, planes, rec, p);
}

template <bool RECORD>
__global__ void __launch_bounds__(THREADS, FWD_MIN_BLOCKS)
fwd_kernel(const float* __restrict__ scene, const float* __restrict__ cam,
           float* __restrict__ planes, int16_t* __restrict__ rec, Params p) {
    fwd_body<RECORD>(scene, cam, planes, rec, p);
}

// The overload of fwd_kernel<RECORD> that stores Index.
template <bool RECORD, class Index>
void (*fwd_function())(const float*, const float*, float*, Index*, Params) {
    return fwd_kernel<RECORD>;
}

// Dynamic shared memory of one block: the trace table and the scene rows.
size_t fwd_smem(int n_objects, int n_spheres) {
    return ((size_t)trace_table_floats(n_objects, n_spheres) + (size_t)n_objects * SCENE_COLS) *
           sizeof(float);
}

template <bool RECORD, class Index>
int launch_fwd(const float* scene, const float* cam, float* planes, Index* rec, const Params& p,
               cudaStream_t s) {
    const size_t smem = fwd_smem(p.n_objects, p.n_spheres);
    dim3 block(BLOCK_W, BLOCK_H);
    dim3 grid((p.width + BLOCK_W - 1) / BLOCK_W, (p.height + BLOCK_H - 1) / BLOCK_H);
    cudaError_t err = cudaFuncSetAttribute(fwd_function<RECORD, Index>(),
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fwd_kernel<RECORD><<<grid, block, smem, s>>>(scene, cam, planes, rec, p);
    return (int)cudaGetLastError();
}

}  // namespace

// Launches the forward kernel on `stream`. scene: (n_objects,16) float32,
// cam: 16 float32, planes: (10,height,width) float32, rec: (bounces*(1+ns),
// height,width) winner indices of index_bytes bytes each (1: int8, 2:
// int16) or null (null selects the non-recording kernel); all device
// pointers. Returns the cudaError_t of the launch (0 = launched).
extern "C" int rt_megakernel_fwd(const float* scene, const float* cam, float* planes, void* rec,
                                 int index_bytes, RT_PARAM_ARGS, void* stream) {
    RT_FILL_PARAMS(p);
    cudaStream_t s = (cudaStream_t)stream;
    if (rec == nullptr) return launch_fwd<false>(scene, cam, planes, (int8_t*)nullptr, p, s);
    if (index_bytes == 1) return launch_fwd<true>(scene, cam, planes, (int8_t*)rec, p, s);
    if (index_bytes == 2) return launch_fwd<true>(scene, cam, planes, (int16_t*)rec, p, s);
    return (int)cudaErrorInvalidValue;
}

// What a launch of the forward kernel takes at this scene size (record 0:
// K1; 1 or 2: the recording one at that many bytes an index): info[0] registers per thread, [1] local memory
// (stack) bytes per thread, [2] static and [3] dynamic shared memory bytes
// per block, [4] 0 (no entry states), [5] blocks resident per SM, [6]
// threads per block. Returns a cudaError_t (0 = success).
extern "C" int rt_megakernel_fwd_info(int n_objects, int n_spheres, int record, int* info) {
    const size_t smem = fwd_smem(n_objects, n_spheres);
    const void* fn = record == 0   ? (const void*)fwd_function<false, int8_t>()
                     : record == 1 ? (const void*)fwd_function<true, int8_t>()
                     : record == 2 ? (const void*)fwd_function<true, int16_t>()
                                   : nullptr;
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    info[0] = attr.numRegs;
    info[1] = (int)attr.localSizeBytes;
    info[2] = (int)attr.sharedSizeBytes;
    info[3] = (int)smem;
    info[4] = 0;
    info[5] = blocks;
    info[6] = THREADS;
    return 0;
}

// Text of a cudaError_t, for the wrapper's exception.
extern "C" const char* rt_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
