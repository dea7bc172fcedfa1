// Fused RT0 Schur direction on z lines, tiled face-major: acc += B_z A_z^{-1}
// B_z^T v, a tile of lines per block, each line cut into chunks.
//
// Replaces the TPU kernel of neutfem_tpu/ops/pallas_fused.py:
//   _fused_z / _body_z  (:466 / :139, z; batch B = 1 or ng)  -- K1
// fused_z_rows_kernel takes one group, fused_z_rows_batched_kernel every
// group at once (group g = blockIdx.y: the Jacobi sweep's flux (ng, 1, nz,
// ny, nx) with per-group face stacks). On z lines every operand is a face
// row contiguous across all lines: line b (the (y, x) plane, lines = ny*nx)
// has its cells at b + e*lines and its staged faces dm (n+1) and l (n) at
// b + f*lines; group g adds g*n*lines to the cells and l, g*(n+1)*lines to
// dm.
//
// Recurrence along a line (f = face 0..n, e = cell 0..n-1, v out of range = 0):
//   b_f = (bx1*v_{f-1} + bx0*v_f)*si
//   z_0 = b_0;        z_f = b_f - l_{f-1}*z_{f-1}
//   F_n = z_n*dm_n;   F_e = z_e*dm_e - l_e*F_{e+1}
//   acc_e += bx0*F_e + bx1*F_{e+1}
//
// Bound on this card: the function reads v, acc, dm and l once and writes
// acc once -- 19.8 MB at IAEA-3D 6x6x4 (12,996 lines of 76 cells, float32),
// 5.9 us at 3.35 TB/s; 70.4 MB at 8x8x8, 21.0 us. 13 flops per cell are far
// below the float32 rate. The thread-per-line kernel it replaced walked
// each line's 2n dependent steps on global memory with a global z scratch.
//
// Design. rows_tile (fused_rows.cu) stages a tile line-major, a row of faces
// per line; here the tile is face-major, s[f][t], because a z face row is
// contiguous across lines in device memory too:
//   load:  one 16-byte cp.async moves 4 neighbouring lines of a face row
//          (float32; 2 in float64) when the line count and every base
//          pointer allow it (kVec), one value per copy otherwise; either way
//          neighbouring threads fill neighbouring addresses, in device and
//          in shared memory, all copies in flight at once.
//   sweeps: thread (t, c) = (tid % TL, tid / TL) runs chunk c of line t. A
//          warp holds 32 lines of one chunk (TL >= 32) or 32/TL chunks of TL
//          lines with chunk starts an odd length apart, so its 32 lanes read
//          32 different banks at every step, with no padding. Pass 1 runs
//          each chunk from 0 and keeps (A, E), the product of its
//          multipliers and its end value; the chunks' pairs go through shared
//          memory and each chunk composes its carry from the chunks before it
//          (after it, backward) in order, E_j + A_j*carry: no shuffles, so a
//          line's chunks may sit in different warps. Pass 2 reruns from the
//          carry and writes z, then F, in place of v.
//   store: acc + divergence, 16 bytes per thread under kVec, coalesced.
// No atomics, and the carry order is fixed: a launch gives the same bits
// every time (the CG's iteration counts are parity observables).
//
// Shared memory: 4 rows of (n+1)*TL values plus 4*CH*TL for the chunk pairs
// -- 39.5 KB at 6x6x4 for TL = 32, CH = 4 in float32. Above 48 KB the
// launcher raises the kernel's dynamic limit; a tile the card refuses is
// reported to the wrapper, which raises.

#include <cuda_runtime.h>

namespace {

// One element global -> shared without a register round trip (cp.async);
// ok false fills zeros and reads nothing.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T)), "r"(ok ? (int)sizeof(T) : 0));
}

// 16 bytes global -> shared (L2 only); ok false fills zeros and reads nothing.
__device__ __forceinline__ void copy_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

template <typename T>
struct alignas(16) Vec16 {
  T x[16 / sizeof(T)];
};

// One tile of one group's z lines.
template <typename T, bool kVec>
__device__ __forceinline__ void z_tile(T* __restrict__ acc, const T* __restrict__ v,
                                       const T* __restrict__ dm, const T* __restrict__ l,
                                       int n, long long lines, int log_tl, int ch, int len, T bx0,
                                       T bx1, T si) {
  constexpr int kLogQ = sizeof(T) == 4 ? 2 : 1;  // values per 16-byte copy: 1 << kLogQ
  extern __shared__ __align__(16) unsigned char smem[];
  const int tl = 1 << log_tl, faces = n + 1, rows = faces << log_tl;
  T* s_v = reinterpret_cast<T*>(smem);  // [f][t]: v, then z, then F
  T* s_d = s_v + rows;
  T* s_l = s_d + rows;
  T* s_a = s_l + rows;
  T* s_x = s_a + rows;  // [4][c][t]: (A, E) of the chunks, forward, then backward
  const int tid = threadIdx.x, nthr = blockDim.x;
  const long long b0 = (long long)blockIdx.x << log_tl;
  const int live = (int)min((long long)tl, lines - b0);  // lines of the tile that exist

  // load: face row f of the tile at s[f*TL .. f*TL + TL), neighbouring lines
  // on neighbouring threads; v, acc and l are 0 at face n
  if (kVec) {
    const int log_per = log_tl - kLogQ;  // copies per face row: 1 << log_per
    for (int i = tid; i < (faces << log_per); i += nthr) {
      const int f = i >> log_per, q = (i & ((1 << log_per) - 1)) << kLogQ;
      const bool ok = q < live, cell = ok && f < n;
      const long long o = ok ? b0 + q + (long long)f * lines : 0;
      const int k = (f << log_tl) + q;
      copy_async16(s_d + k, dm + o, ok);
      copy_async16(s_l + k, l + (cell ? o : 0), cell);
      copy_async16(s_v + k, v + (cell ? o : 0), cell);
      copy_async16(s_a + k, acc + (cell ? o : 0), cell);
    }
  } else {
    for (int i = tid; i < rows; i += nthr) {
      const int f = i >> log_tl, t = i & (tl - 1);
      const bool ok = t < live, cell = ok && f < n;
      const long long o = ok ? b0 + t + (long long)f * lines : 0;
      copy_async(s_d + i, dm + o, ok);
      copy_async(s_l + i, l + (cell ? o : 0), cell);
      copy_async(s_v + i, v + (cell ? o : 0), cell);
      copy_async(s_a + i, acc + (cell ? o : 0), cell);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // the sweeps: thread (t, c) runs faces [s, e) of line t; face f of the
  // line's column at col[f << log_tl]
  const int t = tid & (tl - 1), c = tid >> log_tl;
  const int s = min(c * len, faces), e = min(s + len, faces);
  T* const zc = s_v + t;
  const T* const dc = s_d + t;
  const T* const lc = s_l + t;
  T* const xc = s_x + t;  // pair k of chunk j at xc[(k*ch + j) << log_tl]

  // forward, pass 1: (A, E) of the chunk, b_f from v on the fly
  const T v_in = s > 0 && s < faces ? zc[(s - 1) << log_tl] : T(0);  // v_{s-1}
  T y = 0, A = 1, vp = v_in;
  for (int f = s; f < e; ++f) {
    const T vf = zc[f << log_tl];
    const T bf = (bx1 * vp + bx0 * vf) * si;
    vp = vf;
    const T a = f == 0 ? T(0) : -lc[(f - 1) << log_tl];
    y = bf + a * y;
    A *= a;
  }
  xc[c << log_tl] = A;
  xc[(ch + c) << log_tl] = y;
  __syncthreads();  // every pair is out, every v_{s-1} read
  // carry: chunks 0..c-1 composed in order; pass 2 writes z in place of v
  y = 0;
  for (int j = 0; j < c; ++j) y = xc[(ch + j) << log_tl] + xc[j << log_tl] * y;
  vp = v_in;
  for (int f = s; f < e; ++f) {
    const T vf = zc[f << log_tl];
    const T bf = (bx1 * vp + bx0 * vf) * si;
    vp = vf;
    const T a = f == 0 ? T(0) : -lc[(f - 1) << log_tl];
    y = bf + a * y;
    zc[f << log_tl] = y;
  }

  // backward, pass 1 (this thread reads only the z it wrote)
  y = 0;
  A = 1;
  for (int f = e - 1; f >= s; --f) {
    const T a = f == n ? T(0) : -lc[f << log_tl];
    y = zc[f << log_tl] * dc[f << log_tl] + a * y;
    A *= a;
  }
  xc[(2 * ch + c) << log_tl] = A;
  xc[(3 * ch + c) << log_tl] = y;
  __syncthreads();
  // carry: chunks ch-1..c+1 composed in order; pass 2 writes F in place of z
  y = 0;
  for (int j = ch - 1; j > c; --j) y = xc[(3 * ch + j) << log_tl] + xc[(2 * ch + j) << log_tl] * y;
  for (int f = e - 1; f >= s; --f) {
    const T a = f == n ? T(0) : -lc[f << log_tl];
    y = zc[f << log_tl] * dc[f << log_tl] + a * y;
    zc[f << log_tl] = y;
  }
  __syncthreads();

  // store: acc_e + bx0*F_e + bx1*F_{e+1}, coalesced as the loads
  if (kVec) {
    constexpr int Q = 1 << kLogQ;
    const int log_per = log_tl - kLogQ;
    for (int i = tid; i < (n << log_per); i += nthr) {
      const int e2 = i >> log_per, q = (i & ((1 << log_per) - 1)) << kLogQ;
      if (q >= live) continue;
      const int k = (e2 << log_tl) + q;
      Vec16<T> out;
#pragma unroll
      for (int j = 0; j < Q; ++j)
        out.x[j] = s_a[k + j] + (bx0 * s_v[k + j] + bx1 * s_v[k + tl + j]);
      *reinterpret_cast<Vec16<T>*>(acc + b0 + q + (long long)e2 * lines) = out;
    }
  } else {
    for (int i = tid; i < (n << log_tl); i += nthr) {
      const int e2 = i >> log_tl, t2 = i & (tl - 1);
      if (t2 < live)
        acc[b0 + t2 + (long long)e2 * lines] = s_a[i] + (bx0 * s_v[i] + bx1 * s_v[i + tl]);
    }
  }
}

template <typename T, bool kVec>
__global__ void fused_z_rows_kernel(T* __restrict__ acc, const T* __restrict__ v,
                                    const T* __restrict__ dm, const T* __restrict__ l, int n,
                                    long long lines, int log_tl, int ch, int len, T bx0, T bx1,
                                    T si) {
  z_tile<T, kVec>(acc, v, dm, l, n, lines, log_tl, ch, len, bx0, bx1, si);
}

// Group g = blockIdx.y: its cells and l n*lines apart, its dm (n+1)*lines.
template <typename T, bool kVec>
__global__ void fused_z_rows_batched_kernel(T* __restrict__ acc, const T* __restrict__ v,
                                            const T* __restrict__ dm, const T* __restrict__ l,
                                            int n, long long lines, int log_tl, int ch, int len,
                                            T bx0, T bx1, T si) {
  const long long g = blockIdx.y, cells = g * n * lines;
  z_tile<T, kVec>(acc + cells, v + cells, dm + g * (n + 1) * lines, l + cells, n, lines, log_tl,
                  ch, len, bx0, bx1, si);
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

template <typename T, bool kVec>
int launch_as(void* acc, const void* v, const void* dm, const void* l, int n, long long lines,
              long long groups, int log_tl, int ch, int len, size_t bytes, double bx0,
              double bx1, double si, void* stream) {
  const long long blocks = (lines + (1 << log_tl) - 1) >> log_tl;
  const int threads = ch << log_tl;
  cudaError_t err;
  if (groups == 0) {
    auto kernel = fused_z_rows_kernel<T, kVec>;
    if ((err = allow_smem(kernel, bytes)) != cudaSuccess) return (int)err;
    kernel<<<(unsigned)blocks, threads, bytes, (cudaStream_t)stream>>>(
        (T*)acc, (const T*)v, (const T*)dm, (const T*)l, n, lines, log_tl, ch, len, (T)bx0,
        (T)bx1, (T)si);
  } else {
    auto kernel = fused_z_rows_batched_kernel<T, kVec>;
    if ((err = allow_smem(kernel, bytes)) != cudaSuccess) return (int)err;
    kernel<<<dim3((unsigned)blocks, (unsigned)groups), threads, bytes, (cudaStream_t)stream>>>(
        (T*)acc, (const T*)v, (const T*)dm, (const T*)l, n, lines, log_tl, ch, len, (T)bx0,
        (T)bx1, (T)si);
  }
  return (int)cudaGetLastError();
}

// tl lines per block (8..64), ch chunks per line, powers of two, tl*ch a
// multiple of 32 up to 1024. 16-byte copies where the line count and every
// pointer allow.
template <typename T>
int launch(void* acc, const void* v, const void* dm, const void* l, int n, long long lines,
           long long groups, int tl, int ch, double bx0, double bx1, double si, void* stream) {
  int log_tl = 0;
  while ((1 << log_tl) < tl) ++log_tl;
  const bool pow2 = (1 << log_tl) == tl && ch > 0 && (ch & (ch - 1)) == 0;
  if (!pow2 || tl < 8 || tl > 64 || tl * ch > 1024 || (tl * ch) % 32 != 0 || n < 1 ||
      groups < 0 || groups > 65535)
    return (int)cudaErrorInvalidValue;
  const int faces = n + 1;
  int len = (faces + ch - 1) / ch;
  if (len % 2 == 0) ++len;  // chunk starts an odd length apart: no bank conflicts
  const size_t bytes = (4 * (size_t)faces + 4 * (size_t)ch) * tl * sizeof(T);
  const int q = 16 / (int)sizeof(T);
  const unsigned long long bases = (unsigned long long)acc | (unsigned long long)v |
                                   (unsigned long long)dm | (unsigned long long)l;
  if (lines % q == 0 && bases % 16 == 0)
    return launch_as<T, true>(acc, v, dm, l, n, lines, groups, log_tl, ch, len, bytes, bx0, bx1,
                              si, stream);
  return launch_as<T, false>(acc, v, dm, l, n, lines, groups, log_tl, ch, len, bytes, bx0, bx1,
                             si, stream);
}

}  // namespace

// K1 (groups 0) and its group batch (groups >= 1 groups of ``lines`` lines).
extern "C" int neutfem_fused_z_rows_f32(void* acc, const void* v, const void* dm, const void* l,
                                        int n, long long lines, long long groups, int tl, int ch,
                                        double bx0, double bx1, double si, void* stream) {
  return launch<float>(acc, v, dm, l, n, lines, groups, tl, ch, bx0, bx1, si, stream);
}

extern "C" int neutfem_fused_z_rows_f64(void* acc, const void* v, const void* dm, const void* l,
                                        int n, long long lines, long long groups, int tl, int ch,
                                        double bx0, double bx1, double si, void* stream) {
  return launch<double>(acc, v, dm, l, n, lines, groups, tl, ch, bx0, bx1, si, stream);
}
