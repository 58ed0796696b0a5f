// Backward path-tracing megakernels for NVIDIA Hopper (sm_90a) that keep no
// index planes: "replay" and "direct".
//
// Replace the TPU kernels ray_tracing_tpu/kernels/megakernel.py::
//   _bwd_kernel_replay (K4, launched by _run_bwd's replay arm): a recording
//     pass over the whole scene, the VJP of a loop-free replay of the
//     recorded winners, routing of the winner cotangents to (N,16) rows;
//   _bwd_kernel (K5, launched by _run_bwd's direct arm, N <= 48): the VJP of
//     the estimator through the closest-hit trace itself.
// Both compute the gradients of the fetch kernel (megakernel_bwd.cu, K3),
// from the scene table, the camera pack and the cotangents alone: the
// forward before them is the non-recording one and keeps nothing.
//
// Each is rt_backward.cuh's bwd_kernel (what it computes, its two phases,
// its routing in shared memory) with its own source of winners:
//   RecordedWinners (K4): phase A runs the real closest-hit trace and the
//     shadow trace over the shared-memory trace table, and keeps each saved
//     bounce's primary winner in the bounce's state word in shared memory
//     (rt_backward.cuh, pack_word) beside the masks of its shadow samples;
//     the reverse sweep reads them back, so with a single emitter it traces
//     nothing (the masks say which samples reached the light). A full
//     shadow scan's samples taken, and a bounce deeper than the saved
//     states, are traced again. No winner lives in local memory. This is
//     what the JAX package's RecordingTracer + ReplayTracer compute: the
//     winner's parameters, re-read from the table by index, are the
//     record's planes.
//   TracedWinners (K5): the winners of K4. The JAX package's _bwd_kernel
//     traces again where K4 replays a record, but the walk and the sweep
//     see the same ray bits and the same table, so the walk's winner is the
//     one a trace would find: the sweep takes it from the state word, and
//     the gradients differ from K4's only by the order of float atomics.
//     Direct mode's bound of 48 objects (ops/intersect.py, UNROLL_LIMIT)
//     would let K5 keep its slots in less shared memory and run three
//     blocks per SM; on the H100 that measured slower (80 registers spill
//     852 B; PERF.md, section 6), so K5 keeps K4's launch.
//
// What bounds them on this card: float operations on a lit, enclosed scene,
// where every live bounce traces its ray and its shadow rays against all N
// objects; bytes (the cotangents a pixel needs, 28 B for a path that leaves
// at once) where most paths leave the scene at once. Neither reads index
// planes. As they stand both are limited by what limits K3 (latency,
// divergence, the generator) and by the issue rate of their trace loops,
// which run without fused multiply-adds (--fmad=false), not by either
// bound.

#include "rt_device.cuh"
#include "rt_backward.cuh"

using namespace rt;

namespace {

// K4: the walk traces every call; the sweep takes a saved bounce's primary
// winner from its state word (rt_backward.cuh, pack_word) and finds only
// its t and face again, from its row. With a single emitter the sweep needs
// no shadow winner (the masks say which samples were taken, and each one's
// target is the light); a full shadow scan traces the samples taken again
// for their targets, as does a bounce deeper than the saved states.
struct RecordedWinners {
    static constexpr bool TRACES = true;

    __device__ RecordedWinners(const int*, size_t, size_t) {}

    __device__ __forceinline__ void begin_sweep() {}

    __device__ __forceinline__ int primary(const Tables& sc, const Params&, int, const Ray& r,
                                           int saved, float& t, int& axis) const {
        if (saved >= 0) return winner_hit(sc, r, saved, t, axis);
        return closest(sc.tt, r, t, axis);
    }

    __device__ __forceinline__ int shadow(const Tables& sc, const Params& p, int, int, V3 ro,
                                          V3 rd) const {
        return shadow_winner(sc, p, ro, rd);
    }
};

// K5: K4's winners, in an instantiation of its own (the direct mode's
// kernel, with its own launch count).
struct TracedWinners : RecordedWinners {
    using RecordedWinners::RecordedWinners;
};

}  // namespace

// Launch the replay (K4) or the direct (K5) backward kernel on `stream`.
// The arguments are those of rt_megakernel_bwd (megakernel_bwd.cu), with
// `rec` null: scene (n_objects,16) and cam 16 float32, cot (10,height,width)
// float32 cotangents, g_scene (n_objects,16) and g_cam 16 float32, both ZERO
// at launch, primal (10,height,width) float32 or null. All device pointers.
// Return the cudaError_t of the launch (0 = launched).
extern "C" int rt_megakernel_bwd_replay(const float* scene, const float* cam, const float* cot,
                                        const int* rec, float* g_scene, float* g_cam,
                                        float* primal, RT_PARAM_ARGS, void* stream) {
    RT_FILL_PARAMS(p);
    return launch_bwd<RecordedWinners>(scene, cam, cot, rec, g_scene, g_cam, primal, p, stream);
}

extern "C" int rt_megakernel_bwd_direct(const float* scene, const float* cam, const float* cot,
                                        const int* rec, float* g_scene, float* g_cam,
                                        float* primal, RT_PARAM_ARGS, void* stream) {
    RT_FILL_PARAMS(p);
    return launch_bwd<TracedWinners>(scene, cam, cot, rec, g_scene, g_cam, primal, p, stream);
}

// The launch shapes of the two kernels (rt_backward.cuh, bwd_info): info
// receives 7 ints. Return a cudaError_t (0 = success).
extern "C" int rt_megakernel_bwd_replay_info(int n_objects, int n_spheres, int bounces,
                                             int* info) {
    return bwd_info<RecordedWinners>(n_objects, n_spheres, bounces, info);
}

extern "C" int rt_megakernel_bwd_direct_info(int n_objects, int n_spheres, int bounces,
                                             int* info) {
    return bwd_info<TracedWinners>(n_objects, n_spheres, bounces, info);
}

// Text of a cudaError_t, for the wrapper's exception.
extern "C" const char* rt_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
