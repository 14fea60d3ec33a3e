// SGHMC momentum update for Hopper (sm_90a), in place on g and v.
//
// Replaces bayesdll_tpu/ops/pallas_kernels.py::sghmc_update (_sghmc_kernel).
// Per element, with lr the per-element step size clamped at 1e-30:
//   grad_U = g + mask * (θ - θ0) / σ² / N
//   v'     = (1 - α) v + lr * grad_U + nd * sqrt(2α / (N * lr)) * z
//   g'     = g + v'
// where z ~ N(0,1) comes from normal_from_bits.cuh.  SGD then applies lr to
// g' a second time (core/sgd.py): the reference's double-lr quirk, kept on
// purpose.  There is no gate: every step draws, except when nd = 0, where
// the noise term is zero and the draw is skipped.
//
// What bounds it: memory traffic.  Per element it reads g, θ, θ0, v, mask
// and lr and writes g and v: 32 bytes against ~15 flops (plus 1/4 of a
// Philox call and two Box-Muller transforms per four elements).  The design
// is csghmc_update.cu's: one pass with 16-byte (float4) loads and stores,
// one element quad per thread, a scalar tail for n % 4, no padded copies.
// Each operation is rounded on its own (__fdiv_rn, __fmul_rn, __fadd_rn, no
// fused multiply-add) in the plain PyTorch version's order, so the card
// computes the CPU's bits.  The lr clamp keeps 2α / (N * lr) finite where
// lr = 0, as the TPU kernel does.
//
// The Philox seed and the step come from device memory, an int64 [3] =
// (seed, step, unused) that the kernel reads at each launch: the per-step
// path copies it from pinned host memory without waiting, and the fused
// path's captured CUDA graph fills it before each replay.  The float
// constants come by value.
//
// Contract: elem0 a multiple of 4 with every global quad below 2^32 (else
// cudaErrorInvalidValue and no launch), all pointers 16-byte aligned, fp32,
// n elements each; g and v alias neither each other nor θ, θ0, mask or lr.
// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "normal_from_bits.cuh"

namespace {

struct Scalars {
  float sig2;             // prior_sig², rounded to fp32 on the host
  float n_eff;            // N
  float nd;
  float one_minus_alpha;  // 1 - α, rounded on the host
  float two_alpha;        // 2α, rounded on the host
  uint64_t seed;  // seed and step: read from dev by the kernel
  uint64_t step;
  uint64_t quad0;  // global quad of element 0 (elem0 / 4)
};

__device__ __forceinline__ void update_one(float& g, float& v, float th,
                                           float th0, float mask, float lr,
                                           float z, const Scalars& s) {
  lr = fmaxf(lr, 1e-30f);
  const float grad_u = __fadd_rn(
      g, __fdiv_rn(__fdiv_rn(__fmul_rn(mask, __fsub_rn(th, th0)), s.sig2), s.n_eff));
  float vn = __fadd_rn(__fmul_rn(s.one_minus_alpha, v), __fmul_rn(lr, grad_u));
  if (s.nd != 0.f) {
    const float scale = __fmul_rn(
        s.nd, __fsqrt_rn(__fdiv_rn(s.two_alpha, __fmul_rn(s.n_eff, lr))));
    vn = __fadd_rn(vn, __fmul_rn(scale, z));
  }
  v = vn;
  g = __fadd_rn(g, vn);
}

__global__ void sghmc_update_kernel(float* __restrict__ g,
                                    const float* __restrict__ theta,
                                    const float* __restrict__ theta0,
                                    float* __restrict__ v,
                                    const float* __restrict__ mask,
                                    const float* __restrict__ lr, int64_t n,
                                    Scalars s,
                                    const int64_t* __restrict__ dev) {
  s.seed = static_cast<uint64_t>(dev[0]);  // dev = (seed, step, unused)
  s.step = static_cast<uint64_t>(dev[1]);
  const int64_t full_quads = n / 4;
  const int64_t quads = (n + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       q < quads; q += stride) {
    float z[4] = {0.f, 0.f, 0.f, 0.f};
    if (s.nd != 0.f) {
      bdl::normal4(s.seed, s.quad0 + static_cast<uint64_t>(q), s.step,
                   bdl::kStreamSghmc, z);
    }
    if (q < full_quads) {
      float4 g4 = reinterpret_cast<const float4*>(g)[q];
      float4 v4 = reinterpret_cast<const float4*>(v)[q];
      const float4 th4 = reinterpret_cast<const float4*>(theta)[q];
      const float4 th04 = reinterpret_cast<const float4*>(theta0)[q];
      const float4 m4 = reinterpret_cast<const float4*>(mask)[q];
      const float4 lr4 = reinterpret_cast<const float4*>(lr)[q];
      update_one(g4.x, v4.x, th4.x, th04.x, m4.x, lr4.x, z[0], s);
      update_one(g4.y, v4.y, th4.y, th04.y, m4.y, lr4.y, z[1], s);
      update_one(g4.z, v4.z, th4.z, th04.z, m4.z, lr4.z, z[2], s);
      update_one(g4.w, v4.w, th4.w, th04.w, m4.w, lr4.w, z[3], s);
      reinterpret_cast<float4*>(g)[q] = g4;
      reinterpret_cast<float4*>(v)[q] = v4;
    } else {
      // constant indices into z keep it in registers
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t i = 4 * q + j;
        if (i < n) {
          float gg = g[i], vv = v[i];
          update_one(gg, vv, theta[i], theta0[i], mask[i], lr[i], z[j], s);
          g[i] = gg;
          v[i] = vv;
        }
      }
    }
  }
}

int launch(void* g, const void* theta, const void* theta0, void* v,
           const void* mask, const void* lr, int64_t n, const Scalars& s,
           const void* dev, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 256;
  const int64_t quads = (n + 3) / 4;
  int64_t blocks = (quads + kThreads - 1) / kThreads;
  if (blocks > (int64_t{1} << 20)) blocks = int64_t{1} << 20;  // grid-stride beyond
  sghmc_update_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(g), static_cast<const float*>(theta),
      static_cast<const float*>(theta0), static_cast<float*>(v),
      static_cast<const float*>(mask), static_cast<const float*>(lr), n, s,
      static_cast<const int64_t*>(dev));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// elem0: the global index of element 0, a multiple of 4 (see
// normal_from_bits.cuh), 0 for a whole vector; dev: int64 [3] = (seed,
// step, unused) on the vectors' device
extern "C" int sghmc_update(void* g, const void* theta, const void* theta0,
                            void* v, const void* mask, const void* lr,
                            int64_t n, int64_t elem0, float sig2, float n_eff,
                            float nd, float one_minus_alpha, float two_alpha,
                            const void* dev, void* stream) {
  if (!bdl::valid_offset(elem0, n)) return static_cast<int>(cudaErrorInvalidValue);
  const Scalars s{sig2, n_eff, nd, one_minus_alpha, two_alpha, 0, 0,
                  static_cast<uint64_t>(elem0 / 4)};
  return launch(g, theta, theta0, v, mask, lr, n, s, dev, stream);
}
