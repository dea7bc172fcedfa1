// Fused block-Jacobi apply + CG dots, tiled: (z, <r, z>, <r, r>) for one
// group's float32 residual r, with the per-cell P x P block stored in one of
// three forms:
//   the inverse in float32 or bfloat16:       z_p = sum_q B^-1_pq r_q;
//   the fp8 E-form, E = B^-1 - I in e4m3:     z_p = r_p + sum_q E_pq r_q
//   (the identity part applied exactly).
//
// Replaces the TPU kernel of neutfem_tpu/ops/pallas_blockjac.py: _call /
// _body (K8, :114 / :79; under NEUTFEM_BLOCKJAC=1 on the inverse), and
// serves the default float32 block preconditioner, which the JAX package
// applies to the E-form as an XLA einsum (neutfem_tpu/power.py:271-280).
// blockjac_tiled_kernel takes the inverse forms, blockjac_dev_kernel the
// E-form; both run the body below.
//
// Layouts (cells = nz*ny*nx, the cell index c contiguous in every operand):
//   blk (P, P, cells): entry (p, q) of cell c at (p*P + q)*cells + c;
//   r, z (P, cells) float32;
//   part (blocks, 2) float64: block b's partial <r, z> and <r, r>.
//
// Bound on this card: bytes. The blocks are read once (P^2 entries a cell:
// 1 byte each in e4m3, 2 in bf16), r once and z written once (4 P bytes
// each): 207 MB for the E-form at IAEA-3D 4x4x2 RT2-P2 (P = 27, 219,488
// cells), 62 us at 3.35 TB/s. About one float operation per byte.
//
// Design. The thread-per-cell kernel it replaced moved 2 bytes of a plane
// per lane and load, and kept r in registers, so few warps and few bytes
// stayed in flight. Here a block owns T = 32*V consecutive cells and runs W
// warps; lane L owns the V cells [L*V, L*V + V) of the tile, so one (p, q)
// plane load is V*sizeof(entry) = 8 or 16 bytes (the wrapper's tile,
// ops/blockjac.blockjac_tile, takes 8: a tile of 256 cells in e4m3, 128 in
// bf16, twice the blocks of the 16-byte one, which the card's 132 SMs
// balance better; chip_smoke.py [3] sweeps both):
//   stage:  r's P x T tile goes to shared memory with 16-byte cp.async (one
//           value per copy where the cell count or a pointer does not allow
//           it); its 16-byte units are XOR-swizzled within a row, so the
//           eight lanes of a quarter warp reading their V cells hit
//           different banks.
//   rows:   warp w computes rows p = w, w + W, ...: the P plane loads of a
//           row (unrolled for P = 8 and 27, so all are in flight; streamed
//           past L1), each widened in registers -- bf16 by a shift, e4m3 by
//           the exact cvt e4m3x2 -> f16x2 -> f32 -- and multiplied into V
//           float32 accumulators with q ascending; then z_p = acc (+ r_p for
//           the E-form), stored 16 bytes at a time.
//   dots:   each lane sums r_p z_p and r_p^2 over its rows and cells in
//           order, in float64 (a product of two floats is exact there), the
//           block sums its lanes in a fixed order (shuffles, then the warps
//           in shared memory) and writes one float64 partial pair; the
//           wrapper finishes with one torch.sum and rounds to float32 once.
//           So the dots are the float32 rounding of the exact sums of the
//           float32 z, whatever the tile: the CG's alpha, beta and stop test
//           read them, and its count is a parity observable sensitive to one
//           rounding (HO_TOL's k test sits at float32's resolution of k). No
//           atomics: a launch gives the same bits every time.
// Ragged edge: the last tile masks its cells; the 16-byte paths need the
// cell count a multiple of 16 and every pointer 16-byte aligned (kVec),
// else every access is one value.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 9;  // 27 rows: 3 per warp; 8 rows: 1

// One float global -> shared without a register round trip; ok false fills 0.
__device__ __forceinline__ void copy_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

// 16 bytes global -> shared (L2 only); ok false fills zeros and reads nothing.
__device__ __forceinline__ void copy_async16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

// Position of 16-byte unit u within a staged row of r: lanes L = 0..7 of a
// quarter warp read units L*V/4 + k; flipping the low two bits by bits 3..4
// of u sends them to eight different bank groups for V = 2, 4, 8, 16.
__device__ __forceinline__ int swz(int u) { return u ^ ((u >> 3) & 3); }

// Storage forms: the entry type, its widening, and whether the identity is
// added (the E-form).
enum Form { kF32 = 0, kBF16 = 1, kE4M3 = 2 };

template <int FORM>
struct Entry;
template <>
struct Entry<kF32> {
  using T = float;
};
template <>
struct Entry<kBF16> {
  using T = unsigned short;
};
template <>
struct Entry<kE4M3> {
  using T = unsigned char;
};

// Two e4m3 values (low byte first) -> two floats, exactly: every e4m3 value
// is an f16 value, and every f16 value a float.
__device__ __forceinline__ void e4m3x2_to_f32(unsigned short two, float& a, float& b) {
  unsigned h;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(h) : "h"(two));
  asm("{\n .reg .b16 lo, hi;\n mov.b32 {lo, hi}, %2;\n cvt.f32.f16 %0, lo;\n"
      " cvt.f32.f16 %1, hi;\n}" : "=f"(a), "=f"(b) : "r"(h));
}

// The 32-bit word w of packed entries -> its 4 / sizeof(entry) floats.
template <int FORM>
__device__ __forceinline__ void widen(unsigned w, float* out) {
  if constexpr (FORM == kF32) {
    out[0] = __uint_as_float(w);
  } else if constexpr (FORM == kBF16) {
    out[0] = __uint_as_float(w << 16);
    out[1] = __uint_as_float(w & 0xffff0000u);
  } else {
    e4m3x2_to_f32((unsigned short)(w & 0xffffu), out[0], out[1]);
    e4m3x2_to_f32((unsigned short)(w >> 16), out[2], out[3]);
  }
}

// V entries of one plane at row[0..V) (kVec: one 8- or 16-byte load,
// streamed; else one value at a time, 0 past `live`).
template <int FORM, int V, bool kVec>
__device__ __forceinline__ void load_plane(const typename Entry<FORM>::T* row, int live,
                                           float (&e)[V]) {
  using T = typename Entry<FORM>::T;
  constexpr int kPer = 4 / sizeof(T);  // entries per 32-bit word
  constexpr int kWords = V / kPer;     // 2 or 4
  static_assert(kWords == 2 || kWords == 4, "a plane load is 8 or 16 bytes");
  if constexpr (kVec) {
    unsigned w[kWords];
    if constexpr (kWords == 4) {
      const uint4 x = __ldcs(reinterpret_cast<const uint4*>(row));
      w[0] = x.x;
      w[1] = x.y;
      w[2] = x.z;
      w[3] = x.w;
    } else {
      const uint2 x = __ldcs(reinterpret_cast<const uint2*>(row));
      w[0] = x.x;
      w[1] = x.y;
    }
#pragma unroll
    for (int k = 0; k < kWords; ++k) widen<FORM>(w[k], e + k * kPer);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const T x = j < live ? row[j] : T(0);
      if constexpr (FORM == kF32) {
        e[j] = x;
      } else {
        float f[kPer];
        widen<FORM>((unsigned)x, f);  // the entry in the low bits
        e[j] = f[0];
      }
    }
  }
}

// r[q][cl .. cl + V) from the staged tile (row = s_r + q*T).
template <int V>
__device__ __forceinline__ void load_r(const float* row, int cl, float (&x)[V]) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const float4 f = *reinterpret_cast<const float4*>(row + 4 * swz((cl >> 2) + k));
      x[4 * k] = f.x;
      x[4 * k + 1] = f.y;
      x[4 * k + 2] = f.z;
      x[4 * k + 3] = f.w;
    }
  } else {
    static_assert(V == 2, "V is 2, 4, 8 or 16");
    const float2 f = *reinterpret_cast<const float2*>(row + 4 * swz(cl >> 2) + (cl & 3));
    x[0] = f.x;
    x[1] = f.y;
  }
}

// Sums (a, b) over the block in a fixed order; thread 0 gets the totals.
__device__ __forceinline__ void block_sum2(double& a, double& b) {
  __shared__ double sa[kMaxWarps], sb[kMaxWarps];
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = sa[0];
    b = sb[0];
    for (int w = 1; w < nw; ++w) {
      a += sa[w];
      b += sb[w];
    }
  }
}

// One tile of T = 32*V cells. P > 0: the block size as a constant (rows
// unrolled); P == 0: p_rt at run time.
template <int P, int FORM, int V, bool kVec>
__device__ __forceinline__ void apply_tile(const typename Entry<FORM>::T* __restrict__ blk,
                                           const float* __restrict__ r, float* __restrict__ z,
                                           double* __restrict__ part, int p_rt,
                                           long long cells) {
  constexpr int T = 32 * V;
  constexpr bool kDev = FORM == kE4M3;
  extern __shared__ __align__(16) float s_r[];  // [q][T], 16-byte units swizzled
  const int np = P > 0 ? P : p_rt;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nthr >> 5;
  const long long c0 = (long long)blockIdx.x * T;
  const int live = (int)min((long long)T, cells - c0);  // cells of the tile that exist

  // stage r: row q of the tile at s_r[q*T ..), unit u at 4*swz(u)
  if constexpr (kVec) {
    constexpr int U = T / 4;
    for (int i = tid; i < np * U; i += nthr) {
      const int q = i / U, u = i - q * U;
      const bool ok = 4 * u < live;
      copy_async16(s_r + q * T + 4 * swz(u), r + (ok ? q * cells + c0 + 4 * u : 0), ok);
    }
  } else {
    for (int i = tid; i < np * T; i += nthr) {
      const int q = i / T, k = i - q * T;
      const bool ok = k < live;
      copy_async4(s_r + q * T + 4 * swz(k >> 2) + (k & 3), r + (ok ? q * cells + c0 + k : 0),
                  ok);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const int cl = lane * V;           // this lane's first cell in the tile
  const int mine = min(V, live - cl);  // of its V cells, those that exist
  double rz = 0.0, rr = 0.0;
  if (mine > 0) {
    const typename Entry<FORM>::T* base = blk + c0 + cl;
    for (int p = warp; p < np; p += nw) {
      float acc[V];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = 0.0f;
      const typename Entry<FORM>::T* row = base + (long long)p * np * cells;
      if constexpr (P > 0) {
#pragma unroll
        for (int q = 0; q < P; ++q) {
          float e[V], x[V];
          load_plane<FORM, V, kVec>(row + (long long)q * cells, mine, e);
          load_r<V>(s_r + q * T, cl, x);
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] = fmaf(e[j], x[j], acc[j]);
        }
      } else {
#pragma unroll 2
        for (int q = 0; q < np; ++q) {
          float e[V], x[V];
          load_plane<FORM, V, kVec>(row + (long long)q * cells, mine, e);
          load_r<V>(s_r + q * T, cl, x);
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] = fmaf(e[j], x[j], acc[j]);
        }
      }
      float rp[V];
      load_r<V>(s_r + p * T, cl, rp);
      float* zp = z + (long long)p * cells + c0 + cl;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if constexpr (kDev) acc[j] = rp[j] + acc[j];
        rz = fma((double)rp[j], (double)acc[j], rz);  // past the edge rp = 0: adds nothing
        rr = fma((double)rp[j], (double)rp[j], rr);
      }
      if constexpr (kVec) {
        if constexpr (V >= 4) {
#pragma unroll
          for (int k = 0; k < V / 4; ++k)
            reinterpret_cast<float4*>(zp)[k] =
                make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
        } else {
          *reinterpret_cast<float2*>(zp) = make_float2(acc[0], acc[1]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (j < mine) zp[j] = acc[j];
      }
    }
  }
  block_sum2(rz, rr);
  if (tid == 0) {
    part[2 * blockIdx.x] = rz;
    part[2 * blockIdx.x + 1] = rr;
  }
}

template <int P, int FORM, int V, bool kVec>
__global__ void __launch_bounds__(32 * kMaxWarps)
    blockjac_tiled_kernel(const typename Entry<FORM>::T* __restrict__ blk,
                          const float* __restrict__ r, float* __restrict__ z,
                          double* __restrict__ part, int p_rt, long long cells) {
  apply_tile<P, FORM, V, kVec>(blk, r, z, part, p_rt, cells);
}

template <int P, int V, bool kVec>
__global__ void __launch_bounds__(32 * kMaxWarps)
    blockjac_dev_kernel(const unsigned char* __restrict__ blk, const float* __restrict__ r,
                        float* __restrict__ z, double* __restrict__ part, int p_rt,
                        long long cells) {
  apply_tile<P, kE4M3, V, kVec>(blk, r, z, part, p_rt, cells);
}

// Lets kernel take bytes of dynamic shared memory (above 48 KB it must ask);
// a refusal is cleared, so a later launch does not report it.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

template <int P, int FORM, int V, bool kVec>
int launch_as(const void* blk, const void* r, void* z, void* part, int p_rt, long long cells,
              int warps, void* stream) {
  using T = typename Entry<FORM>::T;
  const int np = P > 0 ? P : p_rt;
  const long long blocks = (cells + 32 * V - 1) / (32 * V);
  const size_t bytes = (size_t)np * 32 * V * sizeof(float);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if constexpr (FORM == kE4M3) {
    auto kernel = blockjac_dev_kernel<P, V, kVec>;
    if ((err = allow_smem(kernel, bytes)) != cudaSuccess) return (int)err;
    kernel<<<(unsigned)blocks, 32 * warps, bytes, s>>>((const unsigned char*)blk,
                                                       (const float*)r, (float*)z,
                                                       (double*)part, p_rt, cells);
  } else {
    auto kernel = blockjac_tiled_kernel<P, FORM, V, kVec>;
    if ((err = allow_smem(kernel, bytes)) != cudaSuccess) return (int)err;
    kernel<<<(unsigned)blocks, 32 * warps, bytes, s>>>((const T*)blk, (const float*)r,
                                                       (float*)z, (double*)part, p_rt, cells);
  }
  return (int)cudaGetLastError();
}

// Unaligned operands (one value per access) take the generic kernel.
template <int P, int FORM, int V>
int launch_v(const void* blk, const void* r, void* z, void* part, int p_rt, long long cells,
             int warps, bool vec, void* stream) {
  if (vec) return launch_as<P, FORM, V, true>(blk, r, z, part, p_rt, cells, warps, stream);
  return launch_as<0, FORM, V, false>(blk, r, z, part, p_rt, cells, warps, stream);
}

// wide: 16-byte plane loads (V = 16 / entry bytes), else 8-byte (half V).
template <int P, int FORM>
int launch_p(const void* blk, const void* r, void* z, void* part, int p_rt, long long cells,
             int wide, int warps, bool vec, void* stream) {
  constexpr int kV = 16 / (int)sizeof(typename Entry<FORM>::T);
  return wide ? launch_v<P, FORM, kV>(blk, r, z, part, p_rt, cells, warps, vec, stream)
              : launch_v<P, FORM, kV / 2>(blk, r, z, part, p_rt, cells, warps, vec, stream);
}

template <int FORM>
int launch(const void* blk, const void* r, void* z, void* part, int P, long long cells,
           int wide, int warps, void* stream) {
  if (P < 1 || cells < 1 || warps < 1 || warps > kMaxWarps || warps > P)
    return (int)cudaErrorInvalidValue;
  const unsigned long long bases =
      (unsigned long long)blk | (unsigned long long)r | (unsigned long long)z;
  const bool vec = cells % 16 == 0 && bases % 16 == 0;
  if (P == 8) return launch_p<8, FORM>(blk, r, z, part, P, cells, wide, warps, vec, stream);
  if (P == 27) return launch_p<27, FORM>(blk, r, z, part, P, cells, wide, warps, vec, stream);
  return launch_p<0, FORM>(blk, r, z, part, P, cells, wide, warps, vec, stream);
}

}  // namespace

// form 0: float32 inverse, 1: bfloat16 inverse, 2: e4m3 E-form. wide 1: a
// tile of 32*16/entry-bytes cells (16-byte plane loads), 0: half of it.
// warps: 1..9, at most P. Writes ceil(cells / tile) float64 partial pairs.
extern "C" int neutfem_blockjac_tiled(int form, const void* blk, const void* r, void* z,
                                      void* part, int P, long long cells, int wide, int warps,
                                      void* stream) {
  switch (form) {
    case kF32:
      return launch<kF32>(blk, r, z, part, P, cells, wide, warps, stream);
    case kBF16:
      return launch<kBF16>(blk, r, z, part, P, cells, wide, warps, stream);
    case kE4M3:
      return launch<kE4M3>(blk, r, z, part, P, cells, wide, warps, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
