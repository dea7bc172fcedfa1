// Equilibration-folded RT0 Schur directions, tiled: the fused direction
// recurrence with the symmetric Jacobi scaling of the CG's matvec
// (sdi * S(sdi * y), sdi = diag(S)^-1/2) folded into the loads and stores, a
// tile of lines per block, each line cut into chunks.
//
// Replaces the TPU kernels of neutfem_tpu/ops/pallas_fused.py (K7):
//   _fused_xT_eq  / _body_xT_eq   (:574 / :236, x, mode 1): (ce*y + X(u), u = sdi*y)
//   _fused_z_eq   / _body_z_eq    (:602 / :274, z, mode 1): sdi*(acc + Z(u))
//   _fused_xT_eq2 / _body_xT_eq2  (:625 / :304, x, mode 2): ce*y + X(sdi*y)
//   _fused_yT_eq2 / _body_yT_eq2  (:652 / :337, y, mode 2): acc + Y(sdi*y)
//   _fused_z_eq2  / _body_z_eq2   (:681 / :367, z, mode 2): sdi*(acc + Z(sdi*y))
// with X, Y, Z the direction operators B_d A_d^-1 B_d^T. One template,
// fused_eq_rows_kernel, serves all five through compile-time flags
// (ops/fused_eq._FLAGS):
//   PRE     the recurrence runs on v = sdi*y, formed in shared memory;
//   EMIT_U  u = sdi*y is written out (mode 1's x kernel);
//   CE      out = ce*y + contribution, acc is not read (both x variants);
//   POST    out = sdi*(acc + contribution) (both z variants).
// Layouts, as fused_rows.cu's: line b is (outer, inner) = (b / inner,
// b % inner), its cells at outer*outer_stride + inner + e*cell_stride, its
// staged face operands (dm = dinv*mask, l) at b + f*lines. The x variants
// (CE) stage y, sdi and ce cell-fastest along each line (cell_stride 1, as
// K3); y and z stage every operand solve-axis-major, neighbouring lines on
// neighbouring threads (as K2).
// The recurrence (f = face 0..n, e = cell 0..n-1, v out of range = 0):
//   b_f = (bx1*v_{f-1} + bx0*v_f)*si
//   z_0 = b_0;        z_f = b_f - l_{f-1}*z_{f-1}
//   F_n = z_n*dm_n;   F_e = z_e*dm_e - l_e*F_{e+1}
//   out_e = base_e + (bx0*F_e + bx1*F_{e+1}),  base = ce*y (CE) or acc
//
// Bound on this card: bytes. One launch reads y, sdi, dm, l and acc or ce
// once and writes the output (and u) once -- 19.8-27.7 MB at IAEA-3D 6x6x4
// (987,696 cells, float32), 7.1-8.3 us at 3.35 TB/s; 14-16 float operations
// per cell are far below the float32 rate. The thread-per-line kernel it
// replaced reached 10-18% of that: 8,664-12,996 lines, one thread each,
// walking 2n dependent steps on global loads with a global (n, lines) z
// scratch.
//
// Design: the tile of fused_rows.cu (rows_tile) with the flags folded in.
// A block owns TL neighbouring lines and runs TL*CH threads, thread (t, c)
// on chunk c of line t (c fastest, so a line's chunks share a warp).
//   load:  y, sdi, acc or ce, dm and l go to shared memory with cp.async,
//          every copy of the tile in flight at once, coalesced as in
//          rows_tile; face n of the cell rows is zero-filled.
//   form:  each chunk turns its own cells into v = sdi*y (PRE; the sdi row
//          then holds u for EMIT_U) and ce into ce*y (CE), in place. The
//          product ce*y is rounded on its own (__fmul_rn), never contracted
//          with the later add: ce reaches 2.8e9 in IAEA-3D's absorber cells,
//          and an FMA there moves the float32 result by more than the
//          contribution's tolerance. The order of the plain version is kept:
//          sdi*y once, then the recurrence on it.
//   sweeps: rows_tile's (pass 1 per chunk, a shuffle scan of the chunks'
//          (A, E) pairs, pass 2 from the true carry), z and F in place of v.
//   store: base + contribution, times sdi (POST), and u (EMIT_U), coalesced
//          as the loads.
// No atomics: a launch gives the same bits every time (the CG's iteration
// counts are parity observables). Kept out of fused_rows.cu so that K2, K3
// and K5 compile to the code they had: a body shared with another kernel
// once slowed ZION 48x48's launches from 621 to 688 us (NVIDIA H100 80GB
// HBM3).
//
// Shared memory: 5 rows of TL*stride values plus TL line offsets -- 26 KB
// for x / y at IAEA-3D 6x6x4 (TL 8, CH 32, float32). The tile rule
// (ops/fused_eq.py eq_tile) halves TL until it fits the card; above 48 KB
// the launcher raises the kernel's dynamic limit, and a tile the card
// refuses is reported to the wrapper, which raises.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

enum : int { kPre = 1, kEmitU = 2, kCe = 4, kPost = 8 };

// One element global -> shared without a register round trip (cp.async);
// ok false fills zeros and reads nothing.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T)), "r"(ok ? (int)sizeof(T) : 0));
}

// a*b rounded on its own: no FMA contraction with a later add.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// kLineMajor: the x variants, whose lines are contiguous (cell_stride 1).
template <typename T, int FLAGS, bool kLineMajor>
__global__ void fused_eq_rows_kernel(T* __restrict__ acc, const T* __restrict__ y,
                                     const T* __restrict__ sdi, const T* __restrict__ ce,
                                     const T* __restrict__ dm, const T* __restrict__ l,
                                     T* __restrict__ u, int n, long long lines, long long inner,
                                     long long outer_stride, long long cell_stride, int log_tl,
                                     int ch, int len, int stride, T bx0, T bx1, T si) {
  constexpr bool PRE = FLAGS & kPre, EMIT_U = FLAGS & kEmitU, CE = FLAGS & kCe,
                 POST = FLAGS & kPost;
  static_assert(PRE || POST, "every variant reads sdi");
  static_assert(!EMIT_U || PRE, "u is sdi*y");
  extern __shared__ __align__(16) unsigned char smem[];
  const int tl = 1 << log_tl;
  long long* s_cb = reinterpret_cast<long long*>(smem);
  T* s_v = reinterpret_cast<T*>(s_cb + tl);  // y, then v (PRE), then z, then F
  T* s_d = s_v + tl * stride;
  T* s_l = s_d + tl * stride;
  T* s_b = s_l + tl * stride;  // the base: acc, or ce then ce*y (CE)
  T* s_s = s_b + tl * stride;  // sdi, then u (EMIT_U)
  const T* base = CE ? ce : acc;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const long long b0 = (long long)blockIdx.x * tl;
  const int faces = n + 1;
  if (tid < tl) {
    const long long b = b0 + tid;
    s_cb[tid] = b < lines ? (b / inner) * outer_stride + (b % inner) : -1;
  }
  __syncthreads();

  // load, every copy in flight at once: dm (faces 0..n), l (0..n-1, 0 at n),
  // neighbouring lines of one face row on neighbouring threads; the cell
  // rows y, base, sdi (0 at n) in the same pattern for y and z, cell-fastest
  // along each line for x
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
        const bool ok = live && f < n;
        const long long c = ok ? cb + (long long)f * cell_stride : 0;
        copy_async(s_v + t * stride + f, y + c, ok);
        copy_async(s_b + t * stride + f, base + c, ok);
        copy_async(s_s + t * stride + f, sdi + c, ok);
      }
    }
  }
  if (kLineMajor) {
    for (int i = tid; i < tl * faces; i += nthr) {
      const int t = i / faces, f = i - t * faces;
      const long long cb = s_cb[t];
      const bool ok = cb >= 0 && f < n;
      const long long c = ok ? cb + (long long)f * cell_stride : 0;
      copy_async(s_v + t * stride + f, y + c, ok);
      copy_async(s_b + t * stride + f, base + c, ok);
      copy_async(s_s + t * stride + f, sdi + c, ok);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // form v, ce*y and u, then the sweeps: thread (t, c) runs faces [s, e) of line t
  {
    const int t = tid / ch, c = tid - t * ch;
    T* zr = s_v + t * stride;
    const T* dr = s_d + t * stride;
    const T* lr = s_l + t * stride;
    const int s = min(c * len, faces), e = min(s + len, faces);
    if (PRE || CE) {
      T* br = s_b + t * stride;
      T* sr = s_s + t * stride;
      for (int f = s; f < min(e, n); ++f) {
        const T yf = zr[f];
        if (CE) br[f] = mul_rn(br[f], yf);
        if (PRE) {
          const T vf = yf * sr[f];
          zr[f] = vf;
          if (EMIT_U) sr[f] = vf;
        }
      }
      __syncwarp();  // a line's chunks share a warp: v_{s-1} is formed
    }

    // forward, pass 1: (A, E) of the chunk, b_f from v on the fly
    const T v_in = s > 0 && s < faces ? zr[s - 1] : T(0);  // v_{s-1}
    T yv = 0, A = 1, vp = v_in;
    for (int f = s; f < e; ++f) {
      const T vf = zr[f];
      const T bf = (bx1 * vp + bx0 * vf) * si;
      vp = vf;
      const T a = f == 0 ? T(0) : -lr[f - 1];
      yv = bf + a * yv;
      A *= a;
    }
    // inclusive scan: (A, yv) become the composition of chunks 0..c
    for (int d = 1; d < ch; d <<= 1) {
      const T Ap = __shfl_up_sync(kFull, A, d, ch);
      const T Ep = __shfl_up_sync(kFull, yv, d, ch);
      if (c >= d) {
        yv = yv + A * Ep;
        A = A * Ap;
      }
    }
    T carry = __shfl_up_sync(kFull, yv, 1, ch);
    __syncwarp();  // every chunk has read its v_{s-1} before z overwrites v
    // pass 2: z in place of v
    yv = c == 0 ? T(0) : carry;
    vp = v_in;
    for (int f = s; f < e; ++f) {
      const T vf = zr[f];
      const T bf = (bx1 * vp + bx0 * vf) * si;
      vp = vf;
      const T a = f == 0 ? T(0) : -lr[f - 1];
      yv = bf + a * yv;
      zr[f] = yv;
    }

    // backward, pass 1 (this thread reads only the z it wrote)
    yv = 0;
    A = 1;
    for (int f = e - 1; f >= s; --f) {
      const T a = f == n ? T(0) : -lr[f];
      yv = zr[f] * dr[f] + a * yv;
      A *= a;
    }
    for (int d = 1; d < ch; d <<= 1) {
      const T An = __shfl_down_sync(kFull, A, d, ch);
      const T En = __shfl_down_sync(kFull, yv, d, ch);
      if (c + d < ch) {
        yv = yv + A * En;
        A = A * An;
      }
    }
    carry = __shfl_down_sync(kFull, yv, 1, ch);
    // pass 2: F in place of z
    yv = c == ch - 1 ? T(0) : carry;
    for (int f = e - 1; f >= s; --f) {
      const T a = f == n ? T(0) : -lr[f];
      yv = zr[f] * dr[f] + a * yv;
      zr[f] = yv;
    }
  }
  __syncthreads();

  // store: base_e + bx0*F_e + bx1*F_{e+1} (times sdi_e under POST), and u
  // under EMIT_U, coalesced as the loads
  auto emit = [&](int t, int e, long long c) {
    const T* F = s_v + t * stride;
    const int k = t * stride + e;
    T out = s_b[k] + (bx0 * F[e] + bx1 * F[e + 1]);
    if (POST) out = s_s[k] * out;
    acc[c] = out;
    if (EMIT_U) u[c] = s_s[k];
  };
  if (kLineMajor) {
    for (int i = tid; i < tl * n; i += nthr) {
      const int t = i / n, e = i - t * n;
      const long long cb = s_cb[t];
      if (cb >= 0) emit(t, e, cb + (long long)e * cell_stride);
    }
  } else {
    const int t = tid & (tl - 1);
    const long long cb = s_cb[t];
    if (cb >= 0) {
      for (int i = tid; i < (n << log_tl); i += nthr) {
        const int e = i >> log_tl;
        emit(t, e, cb + (long long)e * cell_stride);
      }
    }
  }
}

// Chunk length and row stride for (n, tl, ch), as fused_rows.cu's
// tile_layout: len odd, the stride padded against bank conflicts.
inline void tile_layout(int n, int tl, int ch, int* len, int* stride) {
  int ln = (n + 1 + ch - 1) / ch;
  if (ln % 2 == 0) ++ln;
  const int want = ch < 32 ? (ch * ln) % 32 : (tl < 32 ? 32 / tl : 1);
  int st = ch * ln;
  st += ((want - st) % 32 + 32) % 32;
  *len = ln;
  *stride = st;
}

template <typename T, int FLAGS, bool kLineMajor>
int launch(void* acc, const void* y, const void* sdi, const void* ce, const void* dm,
           const void* l, void* u, int n, long long lines, long long inner,
           long long outer_stride, long long cell_stride, int tl, int ch, double bx0,
           double bx1, double si, void* stream) {
  int log_tl = 0;
  while ((1 << log_tl) < tl) ++log_tl;
  const bool pow2 = (1 << log_tl) == tl && ch > 0 && (ch & (ch - 1)) == 0;
  if (!pow2 || ch > 32 || tl * ch < 32 || tl * ch > 1024 || n < 1)
    return (int)cudaErrorInvalidValue;
  int len, stride;
  tile_layout(n, tl, ch, &len, &stride);
  const size_t bytes = (size_t)tl * sizeof(long long) + 5 * (size_t)tl * stride * sizeof(T);
  auto kernel = fused_eq_rows_kernel<T, FLAGS, kLineMajor>;
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // cleared, so a later launch does not report it
      return (int)err;
    }
  }
  const long long blocks = (lines + tl - 1) / tl;
  kernel<<<(unsigned)blocks, tl * ch, bytes, (cudaStream_t)stream>>>(
      (T*)acc, (const T*)y, (const T*)sdi, (const T*)ce, (const T*)dm, (const T*)l, (T*)u, n,
      lines, inner, outer_stride, cell_stride, log_tl, ch, len, stride, (T)bx0, (T)bx1,
      (T)si);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int flags, void* acc, const void* y, const void* sdi, const void* ce,
             const void* dm, const void* l, void* u, int n, long long lines, long long inner,
             long long outer_stride, long long cell_stride, int tl, int ch, double bx0,
             double bx1, double si, void* stream) {
#define NEUTFEM_EQ_ROWS_CASE(F, LINE_MAJOR)                                                 \
  case F:                                                                                   \
    return launch<T, F, LINE_MAJOR>(acc, y, sdi, ce, dm, l, u, n, lines, inner,             \
                                    outer_stride, cell_stride, tl, ch, bx0, bx1, si, stream);
  switch (flags) {
    NEUTFEM_EQ_ROWS_CASE(kPre | kEmitU | kCe, true)  // x, mode 1
    NEUTFEM_EQ_ROWS_CASE(kPost, false)               // z, mode 1
    NEUTFEM_EQ_ROWS_CASE(kPre | kCe, true)           // x, mode 2
    NEUTFEM_EQ_ROWS_CASE(kPre, false)                // y, mode 2
    NEUTFEM_EQ_ROWS_CASE(kPre | kPost, false)        // z, mode 2
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NEUTFEM_EQ_ROWS_CASE
}

}  // namespace

// flags: one of the five sets above (the x sets stage line-major); tl lines
// per block, ch chunks per line: powers of two, ch <= 32, 32 <= tl*ch <= 1024.
extern "C" int neutfem_fused_eq_rows_f32(int flags, void* acc, const void* y, const void* sdi,
                                         const void* ce, const void* dm, const void* l,
                                         void* u, int n, long long lines, long long inner,
                                         long long outer_stride, long long cell_stride, int tl,
                                         int ch, double bx0, double bx1, double si,
                                         void* stream) {
  return dispatch<float>(flags, acc, y, sdi, ce, dm, l, u, n, lines, inner, outer_stride,
                         cell_stride, tl, ch, bx0, bx1, si, stream);
}

extern "C" int neutfem_fused_eq_rows_f64(int flags, void* acc, const void* y, const void* sdi,
                                         const void* ce, const void* dm, const void* l,
                                         void* u, int n, long long lines, long long inner,
                                         long long outer_stride, long long cell_stride, int tl,
                                         int ch, double bx0, double bx1, double si,
                                         void* stream) {
  return dispatch<double>(flags, acc, y, sdi, ce, dm, l, u, n, lines, inner, outer_stride,
                          cell_stride, tl, ch, bx0, bx1, si, stream);
}
