// Backward path-tracing megakernel for NVIDIA Hopper (sm_90a), "fetch".
//
// Replaces the TPU kernel ray_tracing_tpu/kernels/megakernel.py::
// _bwd_kernel_fetch (launched by _run_bwd, fetch arm).
//
// The kernel is rt_backward.cuh's bwd_kernel (what it computes, its two
// phases, its routing) with the winners of the trace calls read from the
// winner-index planes the recording forward stored (one plane per trace
// call: which object each primary and each shadow ray hit, -1 for none; int8
// up to 127 objects, int16 above, kernels/megakernel.py::record_dtype). It is
// instantiated at both widths, and widens each entry to int on load. Nothing
// loops over the objects.
//
// What bounds it on this card: bytes. A pixel needs the three radiance
// cotangents when its path hits anything, the six sky cotangents when it
// leaves the scene (the tenth plane is never read), one primary index per
// bounce it is alive in and one shadow index per accepted sample, so a path
// that leaves at once needs 25 bytes (26 at int16), not the 40 + n_rec
// index entries of its planes.
// It writes N*16+16 floats in all. Float work (replay plus adjoint, a few
// hundred operations per live bounce) is far below the card's rate. What
// limits it is latency and instruction throughput: every live bounce is
// evaluated twice (the walk and its sweep step), with the generator's
// integer work, and the paths of a warp differ in length. The design keeps the rest small: the
// walk loads a bounce's shadow entries together with its primary entry
// (their latencies overlap; a warp reads the same 32- or 64-byte rows for
// its accepted samples anyway), the sweep step reads the walk's masks of
// samples instead of the planes and routes from its own evaluation, the
// entry states live in shared memory (no local memory), and the routing
// reduces by key inside the warp before it touches shared memory.

#include "rt_device.cuh"
#include "rt_backward.cuh"

using namespace rt;

namespace {

// The winner of trace call `index` is the forward's index plane `index`.
// In the walk, with up to PREFETCH shadow samples, a bounce's shadow
// entries are loaded together with its primary entry, rejected samples'
// included, so that their latencies overlap; the sweep reads the walk's
// masks and asks for a shadow entry (from its plane) only in a full shadow
// scan.
constexpr int PREFETCH = 4;

// Index: the planes' element type (int8_t or int16_t); bwd_kernel hands
// their address over as an int*, read back here at this width.
template <class Index>
struct FetchWinners {
    static constexpr bool TRACES = false;
    const Index* at;  // this pixel's entry of the first plane
    size_t plane;
    int pre[PREFETCH];
    bool sweeping;

    __device__ FetchWinners(const int* r, size_t pl, size_t px)
        : at(reinterpret_cast<const Index*>(r) + px), plane(pl), sweeping(false) {}

    __device__ __forceinline__ void begin_sweep() { sweeping = true; }

    __device__ __forceinline__ int primary(const Tables& sc, const Params& p, int b, const Ray& ray,
                                           int, float& t, int& axis) {
        const Index* r = at + (size_t)(b * (1 + p.ns)) * plane;
        if (!sweeping && p.ns <= PREFETCH) {
#pragma unroll
            for (int k = 0; k < PREFETCH; ++k)
                pre[k] = k < p.ns ? (int)r[(size_t)(1 + k) * plane] : -1;
        }
        return winner_hit(sc, ray, (int)r[0], t, axis);
    }

    __device__ __forceinline__ int shadow(const Tables&, const Params& p, int b, int s, V3,
                                          V3) const {
        if (!sweeping && p.ns <= PREFETCH) {
            return s == 0 ? pre[0] : (s == 1 ? pre[1] : (s == 2 ? pre[2] : pre[3]));
        }
        return (int)at[(size_t)(b * (1 + p.ns) + 1 + s) * plane];
    }
};

}  // namespace

// Launches the fetch backward kernel on `stream`. scene: (n_objects,16)
// float32, cam: 16 float32, cot: (10,height,width) float32 cotangents, rec:
// (bounces*(1+ns),height,width) winner indices of index_bytes bytes each (1:
// int8, 2: int16), g_scene: (n_objects,16) and g_cam: 16 float32, both ZERO
// at launch (the kernel adds into them); primal: (10,height,width) float32
// or null (non-null: the kernel also writes the planes its forward walk
// arrives at). All device pointers. Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int rt_megakernel_bwd(const float* scene, const float* cam, const float* cot,
                                 const void* rec, int index_bytes, float* g_scene, float* g_cam,
                                 float* primal, RT_PARAM_ARGS, void* stream) {
    RT_FILL_PARAMS(p);
    if (index_bytes == 1) {
        return launch_bwd<FetchWinners<int8_t>>(scene, cam, cot, (const int*)rec, g_scene, g_cam,
                                                primal, p, stream);
    }
    if (index_bytes == 2) {
        return launch_bwd<FetchWinners<int16_t>>(scene, cam, cot, (const int*)rec, g_scene, g_cam,
                                                 primal, p, stream);
    }
    return (int)cudaErrorInvalidValue;
}

// The launch's shape at this scene size and depth and this width of the
// index planes (rt_backward.cuh, bwd_info): info receives 7 ints. Returns a
// cudaError_t (0 = success).
extern "C" int rt_megakernel_bwd_info(int n_objects, int n_spheres, int bounces, int index_bytes,
                                      int* info) {
    if (index_bytes == 1) return bwd_info<FetchWinners<int8_t>>(n_objects, n_spheres, bounces, info);
    if (index_bytes == 2) return bwd_info<FetchWinners<int16_t>>(n_objects, n_spheres, bounces, info);
    return (int)cudaErrorInvalidValue;
}

// Text of a cudaError_t, for the wrapper's exception.
extern "C" const char* rt_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
