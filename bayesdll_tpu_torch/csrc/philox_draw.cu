// A whole vector of counter-based draws for Hopper (sm_90a): N(0, 1) or
// U[0, 1), keyed by (seed, step, stream).
//
// Replaces the jax.random draws that the JAX package takes inside a
// method's step, with the step's key folded from the (traced) global step:
// VI's reparameterisation eps (bayesdll_tpu/methods/vi.py:78), MC-dropout's
// keep-mask uniforms (bayesdll_tpu/methods/mc_dropout.py:61,85) and the
// Adam-SGHMC and Adam-cSGHMC momentum noise
// (bayesdll_tpu/ops/fused.py:118, bayesdll_tpu/methods/adam_csghmc.py:119).
// None of these is a Pallas kernel; the kernel exists so that the port's
// fused path (a captured CUDA graph of the step) draws anew at each step:
// the pointer entry point reads the seed and the step from device memory,
// which the graph's runner fills before each replay.
//
// Element i takes word i % 4 of the Philox4x32-10 call of quad i / 4 at
// counter (quad, step low word, stream, step high word), the layout of
// normal_from_bits.cuh that the three sampler-update kernels use: normals
// through the same Box-Muller (normal4), uniforms as the same 24-bit
// fractions (uniform4).  Each method's draw has its own stream id, so no
// two draws of one step share bits with each other or with the update
// kernels.
//
// What bounds it: each element is written once (4 bytes) and read from
// nowhere, against 25 integer operations of the Philox rounds per element
// (10 rounds of 2 high and 2 low multiplies, 4 xors and 2 key additions,
// over 4 elements) and, for normals, half a Box-Muller pair.  The integer
// pipes of an SM retire half as many results a clock as its fp32 pipes,
// so the integer work, not the memory traffic, is the larger bound.  The
// design is the plain one: one Philox call per thread and element quad,
// a 16-byte store, a grid-stride loop, a scalar tail for n % 4.
//
// Two entry points share the one kernel body.  `philox_draw` takes the
// seed and the step by value; `philox_draw_dev` reads them from dev, the
// int64 [3] (seed, step, gate) row that the update kernels' pointer entry
// points read (the gate unused here).  At the same (seed, step) the two
// write the same bits.
//
// Contract: out 16-byte aligned fp32 of n elements; kind 0 normal, 1
// uniform.  Launches on `stream`, allocates nothing, does not synchronise;
// returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "normal_from_bits.cuh"

namespace {

constexpr int kNormal = 0;

// kDevScalars: seed and step come from dev = (seed, step, gate)
template <bool kDevScalars>
__global__ void philox_draw_kernel(float* __restrict__ out, int64_t n,
                                   int kind, uint32_t stream_id,
                                   uint64_t seed, uint64_t step,
                                   const int64_t* __restrict__ dev) {
  if constexpr (kDevScalars) {
    seed = static_cast<uint64_t>(dev[0]);
    step = static_cast<uint64_t>(dev[1]);
  }
  const int64_t full_quads = n / 4;
  const int64_t quads = (n + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       q < quads; q += stride) {
    float z[4];
    if (kind == kNormal) {
      bdl::normal4(seed, static_cast<uint64_t>(q), step, stream_id, z);
    } else {
      bdl::uniform4(seed, static_cast<uint64_t>(q), step, stream_id, z);
    }
    if (q < full_quads) {
      reinterpret_cast<float4*>(out)[q] = make_float4(z[0], z[1], z[2], z[3]);
    } else {
      // constant indices into z keep it in registers
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t i = 4 * q + j;
        if (i < n) out[i] = z[j];
      }
    }
  }
}

template <bool kDevScalars>
int launch(void* out, int64_t n, int kind, uint32_t stream_id, uint64_t seed,
           uint64_t step, const void* dev, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 256;
  const int64_t quads = (n + 3) / 4;
  int64_t blocks = (quads + kThreads - 1) / kThreads;
  if (blocks > (int64_t{1} << 20)) blocks = int64_t{1} << 20;  // grid-stride beyond
  philox_draw_kernel<kDevScalars><<<static_cast<unsigned>(blocks), kThreads,
                                    0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), n, kind, stream_id, seed, step,
      static_cast<const int64_t*>(dev));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int philox_draw(void* out, int64_t n, int kind, uint32_t stream_id,
                           uint64_t seed, uint64_t step, void* stream) {
  return launch<false>(out, n, kind, stream_id, seed, step, nullptr, stream);
}

// dev: int64 [3] = (seed, step, gate) on out's device; the gate is unused
extern "C" int philox_draw_dev(void* out, int64_t n, int kind,
                               uint32_t stream_id, const void* dev,
                               void* stream) {
  return launch<true>(out, n, kind, stream_id, 0, 0, dev, stream);
}
