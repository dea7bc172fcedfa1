// Fused block-Jacobi apply + CG dots: z = B^-1 r per cell (P x P), with the
// per-block partial sums of <r, z> and <r, r>.
//
// Replaces the TPU kernel of neutfem_tpu/ops/pallas_blockjac.py: _call / _body
// (K8), reached through blockjac_dots under NEUTFEM_BLOCKJAC=1 with bfloat16
// (or float32) block storage.
//
// Layouts (cells = nz*ny*nx, the cell index c contiguous in every operand):
//   bi (P, P, cells) bfloat16 or float32, entry (p, q) of cell c at (p*P + q)*cells + c;
//   r, z (P, cells) float32;
//   part (blocks, 2) float32: block b's partial <r, z> and <r, r>.
// One thread per cell. Thread c reads bi[p, q, c] for every (p, q): across
// the threads of a warp these are neighbouring addresses, so every load of
// the block tensor coalesces, and the bfloat16 entries are widened to float32
// in registers (the float32 copy the default apply makes is never built).
// The P-vector r[., c] is read once into registers: P is a template constant
// (8 at RT1-P1, 27 at RT2-P2), 27 of a thread's 255 registers, so the P^2
// products reload nothing and only the block tensor streams. Other P take
// the generic kernel, which reads r[q, c] back from L1 in the inner loop.
//
// Dots without atomics: each block sums its threads' products in a fixed
// order (warp shuffles, then the warps in shared memory) and writes one
// partial pair; the wrapper finishes with one torch.sum over the (blocks, 2)
// buffer, as the TPU wrapper's jnp.sum over per-tile partials
// (pallas_blockjac.py:138). The result is the same bit for bit from launch to
// launch, so the CG iteration count (a parity observable) does not vary.
//
// Bound on this card: bytes. It reads the P^2 block planes once (bf16:
// 2 P^2 bytes per cell) and r once and writes z (4 P bytes each); its
// 2 P^2 + 4 P float operations per cell are ~1 per byte, far under the
// card's ~20 float32 operations per byte of HBM traffic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// Sums (a, b) over the block in a fixed order; thread 0 gets the totals.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kThreads / 32], sb[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = sa[0];
    b = sb[0];
    for (int w = 1; w < kThreads / 32; ++w) {
      a += sa[w];
      b += sb[w];
    }
  }
}

template <int P, typename TB>
__global__ void __launch_bounds__(kThreads)
    blockjac_kernel(const TB* __restrict__ bi, const float* __restrict__ r,
                    float* __restrict__ z, float* __restrict__ part, long long cells) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  float rz = 0.0f, rr = 0.0f;
  if (c < cells) {
    float rv[P];
#pragma unroll
    for (int q = 0; q < P; ++q) rv[q] = r[(long long)q * cells + c];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const TB* row = bi + (long long)p * P * cells + c;
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < P; ++q) acc = fmaf(widen(row[(long long)q * cells]), rv[q], acc);
      z[(long long)p * cells + c] = acc;
      rz = fmaf(rv[p], acc, rz);
      rr = fmaf(rv[p], rv[p], rr);
    }
  }
  block_sum2(rz, rr);
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = rz;
    part[2 * blockIdx.x + 1] = rr;
  }
}

template <typename TB>
__global__ void __launch_bounds__(kThreads)
    blockjac_generic_kernel(const TB* __restrict__ bi, const float* __restrict__ r,
                            float* __restrict__ z, float* __restrict__ part, int P,
                            long long cells) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  float rz = 0.0f, rr = 0.0f;
  if (c < cells) {
    for (int p = 0; p < P; ++p) {
      const TB* row = bi + (long long)p * P * cells + c;
      float acc = 0.0f;
      for (int q = 0; q < P; ++q)
        acc = fmaf(widen(row[(long long)q * cells]), __ldg(r + (long long)q * cells + c), acc);
      z[(long long)p * cells + c] = acc;
      const float rp = r[(long long)p * cells + c];
      rz = fmaf(rp, acc, rz);
      rr = fmaf(rp, rp, rr);
    }
  }
  block_sum2(rz, rr);
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = rz;
    part[2 * blockIdx.x + 1] = rr;
  }
}

template <typename TB>
int launch(const void* bi, const void* r, void* z, void* part, int P, long long cells,
           void* stream) {
  const long long blocks = (cells + kThreads - 1) / kThreads;
  const cudaStream_t s = (cudaStream_t)stream;
  const TB* b = (const TB*)bi;
  const float* rv = (const float*)r;
  float* zv = (float*)z;
  float* pv = (float*)part;
  if (P == 8) {
    blockjac_kernel<8, TB><<<(unsigned)blocks, kThreads, 0, s>>>(b, rv, zv, pv, cells);
  } else if (P == 27) {
    blockjac_kernel<27, TB><<<(unsigned)blocks, kThreads, 0, s>>>(b, rv, zv, pv, cells);
  } else {
    blockjac_generic_kernel<TB><<<(unsigned)blocks, kThreads, 0, s>>>(b, rv, zv, pv, P, cells);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Number of (rz, rr) partial pairs a launch over `cells` writes.
extern "C" long long neutfem_blockjac_blocks(long long cells) {
  return (cells + kThreads - 1) / kThreads;
}

extern "C" int neutfem_blockjac_bf16(const void* bi, const void* r, void* z, void* part, int P,
                                     long long cells, void* stream) {
  return launch<__nv_bfloat16>(bi, r, z, part, P, cells, stream);
}

extern "C" int neutfem_blockjac_f32(const void* bi, const void* r, void* z, void* part, int P,
                                    long long cells, void* stream) {
  return launch<float>(bi, r, z, part, P, cells, stream);
}
