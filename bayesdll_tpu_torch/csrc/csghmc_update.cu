// cSGHMC sampler update for Hopper (sm_90a), in place on θ and v.
//
// Replaces bayesdll_tpu/ops/pallas_kernels.py::csghmc_update
// (_csghmc_kernel).  Per element, with lr the per-element step size:
//   grad_U = g + prior_sig * θ
//   v'     = (1 - α) v - lr * grad_U + gate * noise_pref * sqrt(lr) * z
//   θ'     = θ + v'
// where noise_pref = nd * sqrt(2α) / N comes from the host and z ~ N(0,1)
// comes from normal_from_bits.cuh.  gate = 0 (the exploration phase) skips
// the draw entirely.
//
// What bounds it: memory traffic.  Per element it reads g, θ, v and lr and
// writes θ and v: 24 bytes against ~20 flops (plus ~1/4 of a Philox call
// and two Box-Muller transforms per four elements when gate = 1), far below
// the card's flop-per-byte balance.  So the design is one pass over the
// data with 16-byte (float4) loads and stores, one element quad per thread,
// and no padded copies (the TPU wrapper copied every operand into 512x128
// tiles first).  A scalar tail handles n % 4.  The products and sums are
// rounded one by one (no fused multiply-add), as PyTorch's separate
// elementwise kernels round them, so with nd = 0 the result equals the plain
// PyTorch version bit for bit.
//
// The Philox seed, the step and the gate come from device memory, an
// int64 [3] = (seed, step, gate) that the kernel reads at each launch: the
// per-step path copies it from pinned host memory without waiting, and the
// fused path's captured CUDA graph fills it before each replay, so the
// graph does not replay the values it was captured with.  The float
// constants (prior_sig, 1 - α, noise_pref) are fixed for a run and come by
// value.
//
// Contract: elem0 a multiple of 4 with every global quad below 2^32 (else
// cudaErrorInvalidValue and no launch), all pointers 16-byte aligned, fp32,
// n elements each, g and lr not aliasing θ or v.  Launches on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError() after
// the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "normal_from_bits.cuh"

namespace {

struct Scalars {
  float prior_sig;
  float one_minus_alpha;
  float noise_pref;
  int gate;       // gate, seed and step: read from dev by the kernel
  uint64_t seed;
  uint64_t step;
  uint64_t quad0;  // global quad of element 0 (elem0 / 4)
};

__device__ __forceinline__ void update_one(float g, float& th, float& v,
                                           float lr, float z,
                                           const Scalars& s) {
  const float grad_u = __fadd_rn(g, __fmul_rn(s.prior_sig, th));
  float vn = __fsub_rn(__fmul_rn(s.one_minus_alpha, v), __fmul_rn(lr, grad_u));
  if (s.gate) vn = __fadd_rn(vn, __fmul_rn(__fmul_rn(s.noise_pref, sqrtf(lr)), z));
  v = vn;
  th = __fadd_rn(th, vn);
}

__global__ void csghmc_update_kernel(const float* __restrict__ g,
                                     float* __restrict__ theta,
                                     float* __restrict__ v,
                                     const float* __restrict__ lr, int64_t n,
                                     Scalars s,
                                     const int64_t* __restrict__ dev) {
  s.seed = static_cast<uint64_t>(dev[0]);
  s.step = static_cast<uint64_t>(dev[1]);
  s.gate = static_cast<int>(dev[2]);
  const int64_t full_quads = n / 4;
  const int64_t quads = (n + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       q < quads; q += stride) {
    float z[4] = {0.f, 0.f, 0.f, 0.f};
    if (s.gate) {
      bdl::normal4(s.seed, s.quad0 + static_cast<uint64_t>(q), s.step,
                   bdl::kStreamCsghmc, z);
    }
    if (q < full_quads) {
      const float4 g4 = reinterpret_cast<const float4*>(g)[q];
      const float4 lr4 = reinterpret_cast<const float4*>(lr)[q];
      float4 th4 = reinterpret_cast<float4*>(theta)[q];
      float4 v4 = reinterpret_cast<float4*>(v)[q];
      update_one(g4.x, th4.x, v4.x, lr4.x, z[0], s);
      update_one(g4.y, th4.y, v4.y, lr4.y, z[1], s);
      update_one(g4.z, th4.z, v4.z, lr4.z, z[2], s);
      update_one(g4.w, th4.w, v4.w, lr4.w, z[3], s);
      reinterpret_cast<float4*>(theta)[q] = th4;
      reinterpret_cast<float4*>(v)[q] = v4;
    } else {
      // constant indices into z keep it in registers
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t i = 4 * q + j;
        if (i < n) {
          float th = theta[i], vv = v[i];
          update_one(g[i], th, vv, lr[i], z[j], s);
          theta[i] = th;
          v[i] = vv;
        }
      }
    }
  }
}

int launch(const void* g, void* theta, void* v, const void* lr, int64_t n,
           const Scalars& s, const void* dev, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 256;
  const int64_t quads = (n + 3) / 4;
  int64_t blocks = (quads + kThreads - 1) / kThreads;
  if (blocks > (int64_t{1} << 20)) blocks = int64_t{1} << 20;  // grid-stride beyond
  csghmc_update_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<float*>(theta),
      static_cast<float*>(v), static_cast<const float*>(lr), n, s,
      static_cast<const int64_t*>(dev));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// elem0: the global index of element 0, a multiple of 4 (see
// normal_from_bits.cuh), 0 for a whole vector; dev: int64 [3] = (seed,
// step, gate) on the vectors' device
extern "C" int csghmc_update(const void* g, void* theta, void* v,
                             const void* lr, int64_t n, int64_t elem0,
                             float prior_sig, float one_minus_alpha,
                             float noise_pref, const void* dev, void* stream) {
  if (!bdl::valid_offset(elem0, n)) return static_cast<int>(cudaErrorInvalidValue);
  const Scalars s{prior_sig, one_minus_alpha, noise_pref, 0, 0, 0,
                  static_cast<uint64_t>(elem0 / 4)};
  return launch(g, theta, v, lr, n, s, dev, stream);
}
