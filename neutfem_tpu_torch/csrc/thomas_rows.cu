// Batched LDL^T tridiagonal solve along one axis, tiled (K4): a tile of lines
// per block, each line cut into chunks, staged through shared memory.
//
// Replaces the TPU kernels of neutfem_tpu/ops/pallas_tridiag.py dispatched by
// thomas_solve (:253): _solve_z / _z_kernel (:181, axis -3), _solve_rows /
// _rows_kernel (:213, axis -2) and _solve_transpose / _transpose_kernel
// (:229, axis -1), in place of a thread-per-line kernel (since deleted).
// The operands are contiguous with shape (outer, n, inner): line b = (o, i)
// has element k at o*n*inner + i + k*inner and its multipliers l (n-1 per
// line) at o*(n-1)*inner + i + k*inner.
//
//   forward:  z_0 = r_0;              z_k = r_k - l_{k-1} z_{k-1}
//   diagonal: x_{n-1} = z_{n-1} d_{n-1}
//   backward: x_k = z_k d_k - l_k x_{k+1}
//
// Bound on this card: bytes. It reads r, d and l once and writes x once, 16
// bytes an element in float32: 56.2 MB at the IAEA-3D 8x8x8 line
// preconditioner's z solve (1, 152, 152, 152), 16.8 us at 3.35 TB/s. The
// thread-per-line kernel walked each line's 2n dependent steps on device
// memory with z round-tripping through the output: 23,104 lines fill ~5.5
// warps an SM there.
//
// Design: the tile of the tiled K1 (fused_z_rows.cu), without its face rhs
// and divergence.
//   layout: inner > 1 (z, y): face-major, element k of line t at s[k*TL + t],
//           as a face row lies in device memory (TL neighbouring lines of one
//           slab o; blocks walk the slabs' tiles in order). inner == 1 (x):
//           line-major, s[t*stride + k], stride the line length made odd,
//           each line's elements contiguous in device memory.
//   load:   r, d and l of the tile with cp.async, all copies in flight at
//           once; face-major 16 bytes a copy (4 lines in float32, 2 in
//           float64) where inner, TL and every pointer allow it (kVec), one
//           value a copy otherwise; neighbouring threads on neighbouring
//           addresses.
//   sweeps: thread (t, c) = (tid % TL, tid / TL) runs chunk c (an odd length
//           len) of line t. Both sweeps are first-order recurrences y_k =
//           b_k + a_k*y_prev (forward b = r_k, a = -l_{k-1}; backward b =
//           z_k*d_k, a = -l_k, from the last chunk). Pass 1 runs each chunk
//           from 0 and keeps (A, E), the product of its multipliers and its
//           end value; the pairs go through shared memory and each chunk
//           composes its carry from the chunks before (after) it in order,
//           E_j + A_j*carry. Pass 2 reruns from the carry and writes z over r,
//           then x over z: z never leaves shared memory.
//   store:  x, coalesced as the loads (16 bytes a thread under kVec).
// No atomics, and the carry order is fixed: a launch gives the same bits
// every time.
//
// Shared memory: 3 rows of n values per line (r/z/x, d, l) plus 4*CH values
// per line for the chunk pairs -- 62.5 KB at the line path for TL = 32,
// CH = 8 in float32. Above 48 KB the launcher raises the kernel's dynamic
// limit; a tile the card refuses is reported to the wrapper, which raises.

#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T)), "r"(ok ? (int)sizeof(T) : 0));
}

__device__ __forceinline__ void copy_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

template <typename T>
struct alignas(16) Vec16 {
  T x[16 / sizeof(T)];
};

// tiles: tiles per slab (face-major); stride: the line-major row stride.
template <typename T, bool kLineMajor, bool kVec>
__global__ void thomas_rows_kernel(const T* __restrict__ r, const T* __restrict__ d,
                                   const T* __restrict__ l, T* __restrict__ out, int n,
                                   long long outer, long long inner, long long tiles,
                                   int log_tl, int ch, int len, int stride) {
  constexpr int kLogQ = sizeof(T) == 4 ? 2 : 1;  // values per 16-byte copy: 1 << kLogQ
  extern __shared__ __align__(16) unsigned char smem[];
  const int tl = 1 << log_tl;
  const int rows = kLineMajor ? tl * stride : n << log_tl;
  T* s_x = reinterpret_cast<T*>(smem);  // r, then z, then x
  T* s_d = s_x + rows;
  T* s_l = s_d + rows;
  T* s_p = s_l + rows;  // [4][c][t]: (A, E) of the chunks, forward, then backward
  const int tid = threadIdx.x, nthr = blockDim.x;

  // this tile's lines: face-major, slab o's lines b0.. (element k at
  // base + k*inner + t); line-major, lines b0.. of (outer, n)
  long long o, b0, lines;
  if (kLineMajor) {
    o = 0;
    b0 = (long long)blockIdx.x << log_tl;
    lines = outer;
  } else {
    o = blockIdx.x / tiles;
    b0 = ((long long)blockIdx.x - o * tiles) << log_tl;
    lines = inner;
  }
  const int live = (int)min((long long)tl, lines - b0);  // lines of the tile that exist
  const long long xb = kLineMajor ? b0 * n : o * n * inner + b0;
  const long long lb = kLineMajor ? b0 * (n - 1) : o * (n - 1) * inner + b0;

  if (kLineMajor) {
    for (int i = tid; i < live * n; i += nthr) {
      const int t = i / n, k = i - t * n;
      copy_async(s_x + t * stride + k, r + xb + i, true);
      copy_async(s_d + t * stride + k, d + xb + i, true);
    }
    for (int i = tid; i < live * (n - 1); i += nthr) {
      const int t = i / (n - 1), k = i - t * (n - 1);
      copy_async(s_l + t * stride + k, l + lb + i, true);
    }
  } else if (kVec) {
    const int log_per = log_tl - kLogQ;  // copies per face row: 1 << log_per
    for (int i = tid; i < (n << log_per); i += nthr) {
      const int k = i >> log_per, q = (i & ((1 << log_per) - 1)) << kLogQ;
      const bool ok = q < live, lok = ok && k < n - 1;
      const long long e = ok ? (long long)k * inner + q : 0;
      const int s = (k << log_tl) + q;
      copy_async16(s_x + s, r + xb + e, ok);
      copy_async16(s_d + s, d + xb + e, ok);
      copy_async16(s_l + s, l + lb + (lok ? e : 0), lok);
    }
  } else {
    for (int i = tid; i < (n << log_tl); i += nthr) {
      const int k = i >> log_tl, t = i & (tl - 1);
      const bool ok = t < live, lok = ok && k < n - 1;
      const long long e = ok ? (long long)k * inner + t : 0;
      copy_async(s_x + i, r + xb + e, ok);
      copy_async(s_d + i, d + xb + e, ok);
      copy_async(s_l + i, l + lb + (lok ? e : 0), lok);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // the sweeps: thread (t, c) runs elements [s, e) of line t, element k at
  // col[k*step]
  const int t = tid & (tl - 1), c = tid >> log_tl;
  const int s = min(c * len, n), e = min(s + len, n);
  const int step = kLineMajor ? 1 : tl;
  const int col = kLineMajor ? t * stride : t;
  T* const xc = s_x + col;
  const T* const dc = s_d + col;
  const T* const lc = s_l + col;
  T* const pc = s_p + t;  // pair k of chunk j at pc[(k*ch + j) << log_tl]

  // forward, pass 1
  T y = 0, A = 1;
  for (int k = s; k < e; ++k) {
    const T a = k == 0 ? T(0) : -lc[(k - 1) * step];
    y = xc[k * step] + a * y;
    A *= a;
  }
  pc[c << log_tl] = A;
  pc[(ch + c) << log_tl] = y;
  __syncthreads();
  // carry: chunks 0..c-1 composed in order; pass 2 writes z over r
  y = 0;
  for (int j = 0; j < c; ++j) y = pc[(ch + j) << log_tl] + pc[j << log_tl] * y;
  for (int k = s; k < e; ++k) {
    const T a = k == 0 ? T(0) : -lc[(k - 1) * step];
    y = xc[k * step] + a * y;
    xc[k * step] = y;
  }

  // backward, pass 1 (this thread reads only the z it wrote)
  y = 0;
  A = 1;
  for (int k = e - 1; k >= s; --k) {
    const T a = k == n - 1 ? T(0) : -lc[k * step];
    y = xc[k * step] * dc[k * step] + a * y;
    A *= a;
  }
  pc[(2 * ch + c) << log_tl] = A;
  pc[(3 * ch + c) << log_tl] = y;
  __syncthreads();
  // carry: chunks ch-1..c+1 composed in order; pass 2 writes x over z
  y = 0;
  for (int j = ch - 1; j > c; --j) y = pc[(3 * ch + j) << log_tl] + pc[(2 * ch + j) << log_tl] * y;
  for (int k = e - 1; k >= s; --k) {
    const T a = k == n - 1 ? T(0) : -lc[k * step];
    y = xc[k * step] * dc[k * step] + a * y;
    xc[k * step] = y;
  }
  __syncthreads();

  // store x, coalesced as the loads
  if (kLineMajor) {
    for (int i = tid; i < live * n; i += nthr) {
      const int t2 = i / n, k = i - t2 * n;
      out[xb + i] = s_x[t2 * stride + k];
    }
  } else if (kVec) {
    const int log_per = log_tl - kLogQ;
    for (int i = tid; i < (n << log_per); i += nthr) {
      const int k = i >> log_per, q = (i & ((1 << log_per) - 1)) << kLogQ;
      if (q >= live) continue;
      *reinterpret_cast<Vec16<T>*>(out + xb + (long long)k * inner + q) =
          *reinterpret_cast<const Vec16<T>*>(s_x + (k << log_tl) + q);
    }
  } else {
    for (int i = tid; i < (n << log_tl); i += nthr) {
      const int k = i >> log_tl, t2 = i & (tl - 1);
      if (t2 < live) out[xb + (long long)k * inner + t2] = s_x[i];
    }
  }
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

template <typename T, bool kLineMajor, bool kVec>
int launch_as(const void* r, const void* d, const void* l, void* out, int n, long long outer,
              long long inner, int log_tl, int ch, int len, int stride, void* stream) {
  const int tl = 1 << log_tl;
  const int rows = kLineMajor ? tl * stride : n * tl;
  const size_t bytes = (3 * (size_t)rows + 4 * (size_t)ch * tl) * sizeof(T);
  const long long tiles = kLineMajor ? (outer + tl - 1) / tl : (inner + tl - 1) / tl;
  const long long blocks = kLineMajor ? tiles : tiles * outer;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  auto kernel = thomas_rows_kernel<T, kLineMajor, kVec>;
  cudaError_t err;
  if ((err = allow_smem(kernel, bytes)) != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, tl * ch, bytes, (cudaStream_t)stream>>>(
      (const T*)r, (const T*)d, (const T*)l, (T*)out, n, outer, inner, tiles, log_tl, ch, len,
      stride);
  return (int)cudaGetLastError();
}

// tl lines per block (1..64) and ch chunks per line, powers of two, with
// 32 <= tl*ch <= 1024. inner == 1: line-major; else face-major, with
// 16-byte copies where inner, tl and every pointer allow.
template <typename T>
int launch(const void* r, const void* d, const void* l, void* out, int n, long long outer,
           long long inner, int tl, int ch, void* stream) {
  int log_tl = 0;
  while ((1 << log_tl) < tl) ++log_tl;
  const bool pow2 = (1 << log_tl) == tl && ch > 0 && (ch & (ch - 1)) == 0;
  if (!pow2 || tl > 64 || tl * ch < 32 || tl * ch > 1024 || n < 1 || outer < 1 || inner < 1)
    return (int)cudaErrorInvalidValue;
  int len = (n + ch - 1) / ch;
  if (len % 2 == 0) ++len;  // chunk starts an odd length apart: no bank conflicts
  if (inner == 1)
    return launch_as<T, true, false>(r, d, l, out, n, outer, inner, log_tl, ch, len, n | 1,
                                     stream);
  const int q = 16 / (int)sizeof(T);
  const unsigned long long bases = (unsigned long long)r | (unsigned long long)d |
                                   (unsigned long long)l | (unsigned long long)out;
  if (inner % q == 0 && tl % q == 0 && bases % 16 == 0)
    return launch_as<T, false, true>(r, d, l, out, n, outer, inner, log_tl, ch, len, 0, stream);
  return launch_as<T, false, false>(r, d, l, out, n, outer, inner, log_tl, ch, len, 0, stream);
}

}  // namespace

// K4: (outer, n, inner) contiguous operands solved along n; tl lines per
// block, ch chunks per line.
extern "C" int neutfem_thomas_rows_f32(const void* r, const void* d, const void* l, void* out,
                                       int n, long long outer, long long inner, int tl, int ch,
                                       void* stream) {
  return launch<float>(r, d, l, out, n, outer, inner, tl, ch, stream);
}

extern "C" int neutfem_thomas_rows_f64(const void* r, const void* d, const void* l, void* out,
                                       int n, long long outer, long long inner, int tl, int ch,
                                       void* stream) {
  return launch<double>(r, d, l, out, n, outer, inner, tl, ch, stream);
}

// Message for an error code returned by any launcher of the library
// (ops/cuda_lib.check).
extern "C" const char* neutfem_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
