// Batched LDL^T tridiagonal solve for few, long lines, tiled (K4'): a tile of
// neighbouring lines per block, staged through shared memory, each line cut
// into many chunks.
//
// Replaces the TPU kernel neutfem_tpu/ops/pallas_tridiag.py:197 _solve_y
// (_y_kernel :125), dispatched by thomas_solve for a solve along axis -2
// whose rows are too wide for _solve_rows -- the 2D y solves: compute_current's
// (B, 1, 1, ny+1, nx) (ZION 48x48: 1,824 lines of 913 faces; KOEBERG 32x32:
// 2,176 lines of 545) and the 2D line preconditioner's (1, 1, ny, nx). In
// place of a thread-per-chunk kernel (since deleted: 32 lines x 16 chunks per
// block, 57 blocks at ZION, every element read twice from device memory). The operands
// are contiguous with shape (outer, n, inner): line (o, i) has element k at
// o*n*inner + i + k*inner and its multipliers l (n-1 per line) at
// o*(n-1)*inner + i + k*inner.
//
//   forward:  z_0 = r_0;              z_k = r_k - l_{k-1} z_{k-1}
//   diagonal: x_{n-1} = z_{n-1} d_{n-1}
//   backward: x_k = z_k d_k - l_k x_{k+1}
//
// Bound on this card: bytes. It reads r, d and l once and writes x once, 16
// bytes an element in float32: 26.6 MB at ZION's (2, 1, 1, 913, 912), 7.95 us
// at 3.35 TB/s.
//
// Design: few lines, each long, so a block takes TL neighbouring lines (8 at
// the paths' shapes: one 32-byte sector of each face row) and cuts each into
// CH chunks (32 at the paths' shapes, ~29 elements each), TL*CH threads.
//   load:   r, d and l of the tile into shared memory, face-major (element k
//           of line t at k*TL + t, as a face row lies in device memory), with
//           cp.async, every copy in flight at once: 16 bytes a copy where
//           inner, TL and the pointers allow it (kVec), one value otherwise;
//           l's row n-1 (past the last multiplier) is filled with 0. Every
//           element is read once from device memory.
//   sweeps: thread (t, c) = (tid % TL, tid / TL) runs chunk c (an odd length
//           len, so the warp's chunks fall in distinct banks) of line t. Both
//           sweeps are first-order recurrences y_k = b_k + a_k*y_prev
//           (forward b = r_k, a = -l_{k-1}; backward b = z_k*d_k, a = -l_k,
//           from the last chunk). Pass 1 runs the chunk from 0 and keeps
//           (A, E), the product of its multipliers and its end value; the
//           pairs go through shared memory and each chunk composes its carry
//           from the chunks before (after) it in order, E_j + A_j*carry (CH
//           a template parameter: the composition is unrolled). Pass 2 reruns
//           the chunk from the carry: z over r, then x over z.
//   store:  x, coalesced as the loads.
// The bits depend on CH (the chunk boundaries) only, not on TL, and no
// atomics: a launch gives the same bits every time.
//
// Shared memory: 3 rows of n values per line plus 4*CH values per line for
// the chunk pairs -- 91.7 KB at ZION's tile (8 lines x 32 chunks, float32),
// two blocks an SM. Above 48 KB the launcher raises the kernel's dynamic
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

template <typename T, int CH, bool kVec>
__global__ void __launch_bounds__(256)
    thomas_wide_rows_kernel(const T* __restrict__ r, const T* __restrict__ d,
                            const T* __restrict__ l, T* __restrict__ out, int n,
                            long long inner, long long tiles, int log_tl, int len) {
  constexpr int kLogQ = sizeof(T) == 4 ? 2 : 1;  // values per 16-byte copy: 1 << kLogQ
  extern __shared__ __align__(16) unsigned char smem[];
  const int tl = 1 << log_tl;
  const int rows = n << log_tl;
  T* const s_x = reinterpret_cast<T*>(smem);  // r, then z, then x
  T* const s_d = s_x + rows;
  T* const s_l = s_d + rows;
  T* const s_p = s_l + rows;  // [4][CH][TL]: (A, E) forward, then backward
  const int tid = threadIdx.x, nthr = blockDim.x;
  const long long o = blockIdx.x / tiles;
  const long long b0 = ((long long)blockIdx.x - o * tiles) << log_tl;  // first line, slab o
  const int live = (int)min((long long)tl, inner - b0);  // lines of the tile that exist
  const long long xb = o * n * inner + b0;  // element k of line t at xb + k*inner + t
  const long long lb = o * (long long)(n - 1) * inner + b0;

  if (kVec) {
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
    for (int i = tid; i < rows; i += nthr) {
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
  // xc[k << log_tl]
  const int t = tid & (tl - 1), c = tid >> log_tl;
  const int s = min(c * len, n), e = min(s + len, n);
  T* const xc = s_x + t;
  const T* const dc = s_d + t;
  const T* const lc = s_l + t;
  T* const pc = s_p + t;  // pair row q, chunk j at pc[(q*CH + j) << log_tl]

  // forward, pass 1
  T y = 0, A = 1;
  for (int k = s; k < e; ++k) {
    const T a = k == 0 ? T(0) : -lc[(k - 1) << log_tl];
    y = xc[k << log_tl] + a * y;
    A *= a;
  }
  pc[c << log_tl] = A;
  pc[(CH + c) << log_tl] = y;
  __syncthreads();
  // carry: chunks 0..c-1 composed in order; pass 2 writes z over r
  y = 0;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    if (j < c) y = pc[(CH + j) << log_tl] + pc[j << log_tl] * y;
  }
  for (int k = s; k < e; ++k) {
    const T a = k == 0 ? T(0) : -lc[(k - 1) << log_tl];
    y = xc[k << log_tl] + a * y;
    xc[k << log_tl] = y;
  }

  // backward, pass 1 (this thread reads only the z it wrote; l's row n-1 is 0)
  y = 0;
  A = 1;
  for (int k = e - 1; k >= s; --k) {
    const T a = -lc[k << log_tl];
    y = xc[k << log_tl] * dc[k << log_tl] + a * y;
    A *= a;
  }
  pc[(2 * CH + c) << log_tl] = A;
  pc[(3 * CH + c) << log_tl] = y;
  __syncthreads();
  // carry: chunks CH-1..c+1 composed in order; pass 2 writes x over z
  y = 0;
#pragma unroll
  for (int j = CH - 1; j >= 0; --j) {
    if (j > c) y = pc[(3 * CH + j) << log_tl] + pc[(2 * CH + j) << log_tl] * y;
  }
  for (int k = e - 1; k >= s; --k) {
    const T a = -lc[k << log_tl];
    y = xc[k << log_tl] * dc[k << log_tl] + a * y;
    xc[k << log_tl] = y;
  }
  __syncthreads();

  // store x, coalesced as the loads
  if (kVec) {
    const int log_per = log_tl - kLogQ;
    for (int i = tid; i < (n << log_per); i += nthr) {
      const int k = i >> log_per, q = (i & ((1 << log_per) - 1)) << kLogQ;
      if (q >= live) continue;
      *reinterpret_cast<Vec16<T>*>(out + xb + (long long)k * inner + q) =
          *reinterpret_cast<const Vec16<T>*>(s_x + (k << log_tl) + q);
    }
  } else {
    for (int i = tid; i < rows; i += nthr) {
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

template <typename T, int CH, bool kVec>
int launch_as(const void* r, const void* d, const void* l, void* out, int n, long long outer,
              long long inner, int log_tl, int len, void* stream) {
  const int tl = 1 << log_tl;
  const long long tiles = (inner + tl - 1) / tl;
  const long long blocks = tiles * outer;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t bytes = (3 * (size_t)n + 4 * (size_t)CH) * tl * sizeof(T);
  auto kernel = thomas_wide_rows_kernel<T, CH, kVec>;
  cudaError_t err;
  if ((err = allow_smem(kernel, bytes)) != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, tl * CH, bytes, (cudaStream_t)stream>>>(
      (const T*)r, (const T*)d, (const T*)l, (T*)out, n, inner, tiles, log_tl, len);
  return (int)cudaGetLastError();
}

template <typename T, bool kVec>
int launch_ch(const void* r, const void* d, const void* l, void* out, int n, long long outer,
              long long inner, int log_tl, int ch, int len, void* stream) {
  switch (ch) {
    case 16: return launch_as<T, 16, kVec>(r, d, l, out, n, outer, inner, log_tl, len, stream);
    case 32: return launch_as<T, 32, kVec>(r, d, l, out, n, outer, inner, log_tl, len, stream);
    case 64: return launch_as<T, 64, kVec>(r, d, l, out, n, outer, inner, log_tl, len, stream);
    case 128: return launch_as<T, 128, kVec>(r, d, l, out, n, outer, inner, log_tl, len, stream);
    case 256: return launch_as<T, 256, kVec>(r, d, l, out, n, outer, inner, log_tl, len, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// tl lines per block (1..32) and ch chunks per line (16..256), powers of
// two, tl*ch <= 256; 16-byte copies where inner, tl and every pointer allow.
template <typename T>
int launch(const void* r, const void* d, const void* l, void* out, int n, long long outer,
           long long inner, int tl, int ch, void* stream) {
  int log_tl = 0;
  while ((1 << log_tl) < tl) ++log_tl;
  if ((1 << log_tl) != tl || tl > 32 || tl * ch > 256 || n < 1 || outer < 1 || inner < 1)
    return (int)cudaErrorInvalidValue;
  int len = (n + ch - 1) / ch;
  if (len % 2 == 0) ++len;  // chunk starts an odd length apart: no bank conflicts
  const int q = 16 / (int)sizeof(T);
  const unsigned long long bases = (unsigned long long)r | (unsigned long long)d |
                                   (unsigned long long)l | (unsigned long long)out;
  if (inner % q == 0 && tl % q == 0 && bases % 16 == 0)
    return launch_ch<T, true>(r, d, l, out, n, outer, inner, log_tl, ch, len, stream);
  return launch_ch<T, false>(r, d, l, out, n, outer, inner, log_tl, ch, len, stream);
}

}  // namespace

// K4': (outer, n, inner) contiguous operands solved along n; tl lines per
// block, ch chunks per line.
extern "C" int neutfem_thomas_wide_rows_f32(const void* r, const void* d, const void* l,
                                            void* out, int n, long long outer, long long inner,
                                            int tl, int ch, void* stream) {
  return launch<float>(r, d, l, out, n, outer, inner, tl, ch, stream);
}

extern "C" int neutfem_thomas_wide_rows_f64(const void* r, const void* d, const void* l,
                                            void* out, int n, long long outer, long long inner,
                                            int tl, int ch, void* stream) {
  return launch<double>(r, d, l, out, n, outer, inner, tl, ch, stream);
}
