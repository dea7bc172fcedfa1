// Fused RT0 Schur direction, y or x: acc += B_d A_d^{-1} B_d^T v, a tile of
// lines per block, each line cut into chunks.
//
// Replaces the TPU kernels of neutfem_tpu/ops/pallas_fused.py:
//   _fused_yT / _body_yT  (:518 / :398, y direction, solve-axis-major staging) -- K2
//   _fused_xT / _body_xT  (:547 / :202, x direction, pre-transposed staging)   -- K3
// on the operands ops/fused.py stages for them: a line b
// has its cells at cb + e*cell_stride, cb = (b / inner)*outer_stride +
// b % inner, and its staged face operands dm (n+1 faces) and l (n) at
// b + f*lines, solve-axis-major. fused_rows_batched_kernel runs the same tile
// for every group of a group-batched flux (ng, 1, nz, ny, nx), group g =
// blockIdx.y, on ops/fused.py's per-group layouts:
//   _fused_y / _body_y    (:489 / :166, y, per-group factors)                -- K5
//   _fused_x / _body_x    (:704 / :430, x, per-group factors)                -- K5
//
// Recurrence along a line (f = face 0..n, e = cell 0..n-1, v out of range = 0):
//   b_f = (bx1*v_{f-1} + bx0*v_f)*si
//   z_0 = b_0;        z_f = b_f - l_{f-1}*z_{f-1}
//   F_n = z_n*dm_n;   F_e = z_e*dm_e - l_e*F_{e+1}
//   acc_e += bx0*F_e + bx1*F_{e+1}
//
// Bound on this card: the function reads v, acc, dm and l once and writes
// acc once -- 16.6 MB at ZION 48x48 (912 lines of 912 cells, float32), 5.0 us
// at 3.35 TB/s; 13 flops per cell are far below the float32 rate. The
// thread-per-line kernel it replaced reached ~1.5% of that at the 2D rows:
// 912 lines fill 8 blocks on 8 of 132 SMs, each thread walks ~2n dependent
// steps on global loads, the x lines' v and acc reads are strided by nx, and
// z round-trips through a global (n, lines) scratch.
//
// Design. A block owns a tile of TL neighbouring lines and runs TL*CH
// threads: thread (t, c) owns chunk c of line t (lanes: c fastest, so a warp
// holds 32/CH whole lines).
//   load:  the tile's v, acc, dm and l go to shared memory with cp.async, so
//          every copy of the tile is in flight at once and no register waits
//          on one. They are coalesced: dm, l (and y's v, acc) are
//          solve-axis-major, so neighbouring threads take neighbouring lines
//          of one face row (TL*4 bytes, a full 32-byte sector at TL = 8 in
//          float32); x's v and acc are line-major, so neighbouring threads
//          take neighbouring cells of one line.
//   sweeps: each is a first-order linear recurrence y_k = b_k + a_k*y_prev
//          (forward a = -l_{f-1}, b = b_f, formed from v on the fly;
//          backward a = -l_e, b = z_e*dm_e, from the last chunk). Pass 1:
//          each chunk runs its recurrence from 0, keeping its end value E and
//          the product A of its a_k. The pairs compose associatively,
//          (A2, E2)o(A1, E1) = (A2*A1, E2 + A2*E1), so the carries come from a
//          scan over the line's CH chunks in registers (__shfl_up/down_sync,
//          log2 CH steps). Pass 2: each chunk reruns from its true carry and
//          writes z (then F) in place over v (then z) in shared memory -- no
//          global scratch.
//   store: acc + divergence goes back to acc, coalesced as the loads.
// The dependent chain per thread is ~4*len + 2*log2 CH steps on shared
// memory (len = (n+1)/CH rounded up to an odd count) instead of 2n on global
// loads: ~126 at ZION with CH = 32. Chunks start len apart and len is odd,
// and the row stride is padded (tile_layout), so the 32 lanes of a warp hit
// 32 different banks in the sweeps. No atomics: the result is the same bit
// for bit from launch to launch (the CG's iteration counts are parity
// observables).
//
// Shared memory: 4*TL*stride values (v/z/F, dm, l, acc) plus TL line
// offsets -- 119 KB at ZION for TL = 8 in float32, one block per SM. Above
// 48 KB the launcher raises the kernel's dynamic limit; a tile that does not
// fit (TL = 1 and n beyond ~14,500 faces in float32) is refused with the
// runtime's error, and the wrapper raises. Tiles (ops/fused.py rows_tile):
// TL = 8, CH = 32 in float32, the best or within a few per cent of the best
// tile chip_smoke.py [3] sweeps at ZION, KOEBERG and IAEA-3D 6x6x4 on an
// H100 (PERF.md); TL = 4 in float64, the most lines whose tile holds ZION's
// 913 faces.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// One element global -> shared without a register round trip (Ampere's
// cp.async); ok false fills zeros and reads nothing.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T)), "r"(ok ? (int)sizeof(T) : 0));
}

// One tile of one group's lines (the body of both kernels below).
template <typename T, bool kLineMajor>
__device__ __forceinline__ void rows_tile(T* __restrict__ acc, const T* __restrict__ v,
                                          const T* __restrict__ dm, const T* __restrict__ l,
                                          int n, long long lines, long long inner,
                                          long long outer_stride, long long cell_stride,
                                          int log_tl, int ch, int len, int stride, T bx0, T bx1,
                                          T si) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tl = 1 << log_tl;
  long long* s_cb = reinterpret_cast<long long*>(smem);
  T* s_v = reinterpret_cast<T*>(s_cb + tl);  // v, then z, then F
  T* s_d = s_v + tl * stride;
  T* s_l = s_d + tl * stride;
  T* s_a = s_l + tl * stride;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const long long b0 = (long long)blockIdx.x * tl;
  const int faces = n + 1;
  if (tid < tl) {
    const long long b = b0 + tid;
    s_cb[tid] = b < lines ? (b / inner) * outer_stride + (b % inner) : -1;
  }
  __syncthreads();

  // load, every copy in flight at once: dm (faces 0..n), l (0..n-1, 0 at n),
  // neighbouring lines of one face row on neighbouring threads (nthr is a
  // multiple of tl, so a thread keeps its line); v and acc (cells 0..n-1, v 0
  // at n) in the same pattern for y, cell-fastest along each line for x
  {
    const int t = tid & (tl - 1);
    const long long b = b0 + t, cb = s_cb[t];
    const bool live = cb >= 0;
    for (int i = tid; i < (faces << log_tl); i += nthr) {
      const int f = i >> log_tl;
      const long long o = live ? b + (long long)f * lines : 0;
      copy_async(s_d + t * stride + f, dm + o, live);
      copy_async(s_l + t * stride + f, l + (f < n ? o : 0), live && f < n);
      if (!kLineMajor) {
        const long long c = live && f < n ? cb + (long long)f * cell_stride : 0;
        copy_async(s_v + t * stride + f, v + c, live && f < n);
        copy_async(s_a + t * stride + f, acc + c, live && f < n);
      }
    }
  }
  if (kLineMajor) {
    for (int i = tid; i < tl * faces; i += nthr) {
      const int t = i / faces, f = i - t * faces;
      const long long cb = s_cb[t];
      const bool ok = cb >= 0 && f < n;
      const long long c = ok ? cb + (long long)f * cell_stride : 0;
      copy_async(s_v + t * stride + f, v + c, ok);
      copy_async(s_a + t * stride + f, acc + c, ok);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // the sweeps: thread (t, c) runs faces [s, e) of line t
  {
    const int t = tid / ch, c = tid - t * ch;
    T* zr = s_v + t * stride;
    const T* dr = s_d + t * stride;
    const T* lr = s_l + t * stride;
    const int s = min(c * len, faces), e = min(s + len, faces);

    // forward, pass 1: (A, E) of the chunk, b_f from v on the fly
    const T v_in = s > 0 && s < faces ? zr[s - 1] : T(0);  // v_{s-1}
    T y = 0, A = 1, vp = v_in;
    for (int f = s; f < e; ++f) {
      const T vf = zr[f];
      const T bf = (bx1 * vp + bx0 * vf) * si;
      vp = vf;
      const T a = f == 0 ? T(0) : -lr[f - 1];
      y = bf + a * y;
      A *= a;
    }
    // inclusive scan: (A, y) become the composition of chunks 0..c
    for (int d = 1; d < ch; d <<= 1) {
      const T Ap = __shfl_up_sync(kFull, A, d, ch);
      const T Ep = __shfl_up_sync(kFull, y, d, ch);
      if (c >= d) {
        y = y + A * Ep;
        A = A * Ap;
      }
    }
    T carry = __shfl_up_sync(kFull, y, 1, ch);
    __syncwarp();  // every chunk has read its v_{s-1} before z overwrites v
    // pass 2: z in place of v
    y = c == 0 ? T(0) : carry;
    vp = v_in;
    for (int f = s; f < e; ++f) {
      const T vf = zr[f];
      const T bf = (bx1 * vp + bx0 * vf) * si;
      vp = vf;
      const T a = f == 0 ? T(0) : -lr[f - 1];
      y = bf + a * y;
      zr[f] = y;
    }

    // backward, pass 1 (this thread reads only the z it wrote)
    y = 0;
    A = 1;
    for (int f = e - 1; f >= s; --f) {
      const T a = f == n ? T(0) : -lr[f];
      y = zr[f] * dr[f] + a * y;
      A *= a;
    }
    for (int d = 1; d < ch; d <<= 1) {
      const T An = __shfl_down_sync(kFull, A, d, ch);
      const T En = __shfl_down_sync(kFull, y, d, ch);
      if (c + d < ch) {
        y = y + A * En;
        A = A * An;
      }
    }
    carry = __shfl_down_sync(kFull, y, 1, ch);
    // pass 2: F in place of z
    y = c == ch - 1 ? T(0) : carry;
    for (int f = e - 1; f >= s; --f) {
      const T a = f == n ? T(0) : -lr[f];
      y = zr[f] * dr[f] + a * y;
      zr[f] = y;
    }
  }
  __syncthreads();

  // store: acc_e + bx0*F_e + bx1*F_{e+1}, coalesced as the loads
  if (kLineMajor) {
    for (int i = tid; i < tl * n; i += nthr) {
      const int t = i / n, e = i - t * n;
      const long long cb = s_cb[t];
      if (cb < 0) continue;
      const T* F = s_v + t * stride;
      acc[cb + (long long)e * cell_stride] =
          s_a[t * stride + e] + (bx0 * F[e] + bx1 * F[e + 1]);
    }
  } else {
    const int t = tid & (tl - 1);
    const long long cb = s_cb[t];
    if (cb >= 0) {
      const T* F = s_v + t * stride;
      for (int i = tid; i < (n << log_tl); i += nthr) {
        const int e = i >> log_tl;
        acc[cb + (long long)e * cell_stride] =
            s_a[t * stride + e] + (bx0 * F[e] + bx1 * F[e + 1]);
      }
    }
  }
}

template <typename T, bool kLineMajor>
__global__ void fused_rows_kernel(T* __restrict__ acc, const T* __restrict__ v,
                                  const T* __restrict__ dm, const T* __restrict__ l, int n,
                                  long long lines, long long inner, long long outer_stride,
                                  long long cell_stride, int log_tl, int ch, int len,
                                  int stride, T bx0, T bx1, T si) {
  rows_tile<T, kLineMajor>(acc, v, dm, l, n, lines, inner, outer_stride, cell_stride, log_tl,
                           ch, len, stride, bx0, bx1, si);
}

// The group-batched directions (K5): group g = blockIdx.y has its cells at
// g*group_stride and its staged face operands in its own blocks, dm at
// g*(n+1)*lines and l at g*n*lines (ops/fused.py's batched layout);
// lines counts one group's lines.
template <typename T, bool kLineMajor>
__global__ void fused_rows_batched_kernel(T* __restrict__ acc, const T* __restrict__ v,
                                          const T* __restrict__ dm, const T* __restrict__ l,
                                          int n, long long lines, long long inner,
                                          long long outer_stride, long long cell_stride,
                                          long long group_stride, int log_tl, int ch, int len,
                                          int stride, T bx0, T bx1, T si) {
  const long long g = blockIdx.y;
  rows_tile<T, kLineMajor>(acc + g * group_stride, v + g * group_stride,
                           dm + g * (n + 1) * lines, l + g * n * lines, n, lines, inner,
                           outer_stride, cell_stride, log_tl, ch, len, stride, bx0, bx1, si);
}

// Chunk length and row stride for (n, tl, ch): len odd, so the chunk starts
// c*len of a warp's lanes fall in different banks; with several lines per
// warp (ch < 32) the row stride continues that pattern (stride = ch*len mod
// 32), with one line per warp it spreads the load's face rows (32/tl mod 32).
inline void tile_layout(int n, int tl, int ch, int* len, int* stride) {
  int ln = (n + 1 + ch - 1) / ch;
  if (ln % 2 == 0) ++ln;
  const int want = ch < 32 ? (ch * ln) % 32 : (tl < 32 ? 32 / tl : 1);
  int st = ch * ln;
  st += ((want - st) % 32 + 32) % 32;
  *len = ln;
  *stride = st;
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

// groups 0: the one-group kernel; else the batched kernel over that many
// groups (group_stride: one group's cells).
template <typename T, bool kLineMajor>
int launch(void* acc, const void* v, const void* dm, const void* l, int n, long long lines,
           long long groups, long long inner, long long outer_stride, long long cell_stride,
           long long group_stride, int tl, int ch, double bx0, double bx1, double si,
           void* stream) {
  int log_tl = 0;
  while ((1 << log_tl) < tl) ++log_tl;
  const bool pow2 = (1 << log_tl) == tl && ch > 0 && (ch & (ch - 1)) == 0;
  if (!pow2 || ch > 32 || tl * ch < 32 || tl * ch > 1024 || n < 1 || groups < 0 ||
      groups > 65535)
    return (int)cudaErrorInvalidValue;
  int len, stride;
  tile_layout(n, tl, ch, &len, &stride);
  const size_t bytes = (size_t)tl * sizeof(long long) + 4 * (size_t)tl * stride * sizeof(T);
  const long long blocks = (lines + tl - 1) / tl;
  cudaError_t err;
  if (groups == 0) {
    auto kernel = fused_rows_kernel<T, kLineMajor>;
    if ((err = allow_smem(kernel, bytes)) != cudaSuccess) return (int)err;
    kernel<<<(unsigned)blocks, tl * ch, bytes, (cudaStream_t)stream>>>(
        (T*)acc, (const T*)v, (const T*)dm, (const T*)l, n, lines, inner, outer_stride,
        cell_stride, log_tl, ch, len, stride, (T)bx0, (T)bx1, (T)si);
  } else {
    auto kernel = fused_rows_batched_kernel<T, kLineMajor>;
    if ((err = allow_smem(kernel, bytes)) != cudaSuccess) return (int)err;
    kernel<<<dim3((unsigned)blocks, (unsigned)groups), tl * ch, bytes,
             (cudaStream_t)stream>>>((T*)acc, (const T*)v, (const T*)dm, (const T*)l, n, lines,
                                     inner, outer_stride, cell_stride, group_stride, log_tl,
                                     ch, len, stride, (T)bx0, (T)bx1, (T)si);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any(void* acc, const void* v, const void* dm, const void* l, int n,
               long long lines, long long groups, long long inner, long long outer_stride,
               long long cell_stride, long long group_stride, int line_major, int tl, int ch,
               double bx0, double bx1, double si, void* stream) {
  return line_major
             ? launch<T, true>(acc, v, dm, l, n, lines, groups, inner, outer_stride,
                               cell_stride, group_stride, tl, ch, bx0, bx1, si, stream)
             : launch<T, false>(acc, v, dm, l, n, lines, groups, inner, outer_stride,
                                cell_stride, group_stride, tl, ch, bx0, bx1, si, stream);
}

}  // namespace

// line_major: 1 when a line's cells are contiguous (x: cell_stride 1), so v
// and acc are staged cell-fastest; 0 when neighbouring lines are (y).
// tl lines per block, ch chunks per line: powers of two, ch <= 32,
// 32 <= tl*ch <= 1024.
extern "C" int neutfem_fused_rows_f32(void* acc, const void* v, const void* dm, const void* l,
                                      int n, long long lines, long long inner,
                                      long long outer_stride, long long cell_stride,
                                      int line_major, int tl, int ch, double bx0, double bx1,
                                      double si, void* stream) {
  return launch_any<float>(acc, v, dm, l, n, lines, 0, inner, outer_stride, cell_stride, 0,
                           line_major, tl, ch, bx0, bx1, si, stream);
}

extern "C" int neutfem_fused_rows_f64(void* acc, const void* v, const void* dm, const void* l,
                                      int n, long long lines, long long inner,
                                      long long outer_stride, long long cell_stride,
                                      int line_major, int tl, int ch, double bx0, double bx1,
                                      double si, void* stream) {
  return launch_any<double>(acc, v, dm, l, n, lines, 0, inner, outer_stride, cell_stride, 0,
                            line_major, tl, ch, bx0, bx1, si, stream);
}

// The group-batched form (K5): groups >= 1 groups of ``lines`` lines each,
// group_stride cells apart, each group's dm / l in its own staged block.
extern "C" int neutfem_fused_rows_batched_f32(void* acc, const void* v, const void* dm,
                                              const void* l, int n, long long lines,
                                              long long groups, long long inner,
                                              long long outer_stride, long long cell_stride,
                                              long long group_stride, int line_major, int tl,
                                              int ch, double bx0, double bx1, double si,
                                              void* stream) {
  if (groups < 1) return (int)cudaErrorInvalidValue;
  return launch_any<float>(acc, v, dm, l, n, lines, groups, inner, outer_stride, cell_stride,
                           group_stride, line_major, tl, ch, bx0, bx1, si, stream);
}

extern "C" int neutfem_fused_rows_batched_f64(void* acc, const void* v, const void* dm,
                                              const void* l, int n, long long lines,
                                              long long groups, long long inner,
                                              long long outer_stride, long long cell_stride,
                                              long long group_stride, int line_major, int tl,
                                              int ch, double bx0, double bx1, double si,
                                              void* stream) {
  if (groups < 1) return (int)cudaErrorInvalidValue;
  return launch_any<double>(acc, v, dm, l, n, lines, groups, inner, outer_stride, cell_stride,
                            group_stride, line_major, tl, ch, bx0, bx1, si, stream);
}
