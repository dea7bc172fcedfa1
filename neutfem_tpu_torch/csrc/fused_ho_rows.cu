// Fused condensed Schur direction for k >= 1 (RT_k-P_k, K1 = k+1 longitudinal
// flux modes): acc += (B_d A_d^{-1} B_d^T + Qbub/alpha) v, a tile of lines and
// a group of transverse modes per block, each (transverse mode, line) cut into
// chunks.
//
// Replaces the TPU kernels of neutfem_tpu/ops/pallas_fused_ho.py (K6):
//   _fused_z_ho / _body_z_ho  (:460 / :125, z direction, natural face layout)
//   _fused_y_ho / _body_y_ho  (:389 / :175, y direction, solve-axis-major staging)
//   _fused_x_ho / _body_x_ho  (:425 / :231, x direction; here the unpadded
//                              (nx+1 / nx, nz*ny) layout)
// on the operands ops/fused_ho.py stages: a line b has its cells
// at cb + e*cell_stride inside each mode plane, cb = (b / inner)*outer_stride +
// b % inner, and its staged face operands (dm = dinv*mask, l, alpha) at
// b + f*lines, solve-axis-major.
//
// Mode index (the contract ops/fused_ho.kernel_mode_index mirrors): the flux
// is (P, nz, ny, nx) with P = K1^3 split as (K1[pz], K1[py], K1[px]), x
// fastest; the longitudinal index l is the solve axis's own exponent (stride
// K1^lpow: x 1, y K1, z K1^2), the transverse mode t = t_lo + K1*t_hi runs
// over the other two exponents, lower stride first.
//
// Recurrence per (t, line), tables of row t (bxs = BXc/m_t, bxo = BXc, q = Qbub):
//   rf_f = sum_l bxs[1][l]*v[l][f-1] + bxs[0][l]*v[l][f]     (v out of range = 0)
//   z_0 = rf_0;  z_f = rf_f - l_{f-1}*z_{f-1}
//   F_n = z_n*dm_n;  F_e = z_e*dm_e - l_e*F_{e+1}
//   acc[l][e] += bxo[0][l]*F_e + bxo[1][l]*F_{e+1} + (sum_l' q[l][l']*v[l'][e]) / alpha_e
// Pinned faces carry l = 0 and dm = 0 (the context zeroes the off-diagonal
// before factoring), so no mask plane is read.
//
// Bound on this card: the function reads v, acc and the three face operands
// once and writes acc once -- 73.7 MB at RT2-P2 4x4x2 (76x76x38 cells, P = 27,
// float32), 22 us at 3.35 TB/s; ~20 flops per value are far below the
// float32 rate. The thread-per-(t, line) kernel it replaced reached 12-20%
// of that: 26k-52k threads each walk ~2n dependent steps on global loads, z
// round-trips through a global (T, n, lines) scratch, every face operand is
// read by all K1^2 threads of a line, and the x lines' v and acc reads are
// strided by nx.
//
// Design (that of fused_rows.cu, split by transverse mode). The items of
// different t share only the face operands, so a block owns a tile of TL
// neighbouring lines and a group of TG transverse modes (the K1*TG mode
// planes of those t), and runs TG * TL * CH threads: thread (t, line, c)
// owns chunk c of the faces of (t, line) (c fastest, then the line, then t,
// so a warp holds 32/CH lines of one t and whole chunk groups). The K1^2/TG
// blocks of one tile are neighbours in the grid, so the face operands they
// all read come from L2 after the first.
//   load:  the tile's mode planes of v and acc and its dm, l and alpha go to
//          shared memory with cp.async, the whole tile in flight at once.
//          Coalesced: dm, l, alpha (and z's and y's v and acc) take
//          neighbouring lines of one face row on neighbouring threads (TL*4
//          bytes: TL = 16 fills two 32-byte sectors in float32); x's v and
//          acc take neighbouring cells of one line. The TG rows of the
//          coefficient table (4*K1 + K1^2 each) are copied once per block.
//   sweeps: each is a first-order linear recurrence y_k = b_k + a_k*y_prev
//          (forward: b = rf_f from the K1 longitudinal modes of v, a =
//          -l_{f-1}; backward: b = z_e*dm_e, a = -l_e). Pass 1: each chunk
//          runs from 0, keeping its end value E and the product A of its a_k;
//          the pairs compose, (A2, E2)o(A1, E1) = (A2*A1, E2 + A2*E1), so a
//          shuffle scan over the CH chunks (log2 CH steps) gives the carries;
//          pass 2 reruns each chunk from its carry and writes z, then F in
//          place of z, into the (t, line) row of shared memory -- no global
//          scratch. v stays: the store reads it for the bubble term.
//   store: acc + divergence + bubble term from shared memory to acc, as the
//          load; each value of acc is read once and written once.
// Rows are padded (tile_layout: chunk length odd, row stride congruent to
// CH*len mod 32), so the 32 lanes of a warp hit 32 banks in the sweeps. No
// atomics: the result is the same bit for bit from launch to launch (the CG's
// iteration counts are parity observables).
//
// Shared memory: (TG*(2*K1 + 1) + 3)*TL rows of the padded stride, plus the
// table rows and TL line offsets -- 56 KB at RT2-P2 y / x in float32 for
// TL = 16, TG = 1 (ops/fused_ho.ho_smem). Above 48 KB the launcher raises
// the kernel's dynamic limit; a tile that does not fit is refused with the
// runtime's error (cleared here), and the wrapper raises.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// One element global -> shared without a register round trip (cp.async); ok
// false fills zeros and reads nothing.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T)), "r"(ok ? (int)sizeof(T) : 0));
}

// Division by a runtime constant d >= 1 without a divide (the round-up
// multiply-shift of PyTorch's IntDivider): exact for 0 <= k < 2^31.
struct FastDiv {
  unsigned magic, shift;
  __device__ __forceinline__ int div(int k) const {
    return (int)((__umulhi((unsigned)k, magic) + (unsigned)k) >> shift);
  }
};

inline FastDiv fast_div(int d) {
  unsigned shift = 0;
  while (shift < 32 && (1ull << shift) < (unsigned long long)d) ++shift;
  const unsigned long long magic =
      ((1ull << 32) * ((1ull << shift) - (unsigned long long)d)) / (unsigned long long)d + 1;
  return {(unsigned)magic, shift};
}

template <typename T, int K1, bool kLineMajor>
__global__ void fused_ho_rows_kernel(T* __restrict__ acc, const T* __restrict__ v,
                                     const T* __restrict__ dm, const T* __restrict__ l,
                                     const T* __restrict__ alpha, const T* __restrict__ tab,
                                     int lpow, int n, long long lines, long long inner,
                                     long long outer_stride, long long cell_stride,
                                     long long plane, int log_tl, int ch, int tg, int len,
                                     int stride, FastDiv divn) {
  constexpr int TM = K1 * K1, NT = 4 * K1 + K1 * K1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tl = 1 << log_tl, np = tg * K1;  // lines and mode planes of the tile
  const int groups = TM / tg, t0 = (blockIdx.x % groups) * tg;
  const long long b0 = (long long)(blockIdx.x / groups) * tl;
  long long* s_cb = reinterpret_cast<long long*>(smem);
  T* s_tab = reinterpret_cast<T*>(s_cb + tl);  // table rows t0 .. t0+tg-1
  T* s_v = s_tab + tg * NT;         // np*TL rows: (plane j = (t - t0)*K1 + l, line)
  T* s_c = s_v + np * tl * stride;  // acc, the same rows
  T* s_z = s_c + np * tl * stride;  // tg*TL rows: (t - t0, line); z, then F
  T* s_d = s_z + tg * tl * stride;  // TL rows each: dm, l, alpha
  T* s_l = s_d + tl * stride;
  T* s_a = s_l + tl * stride;
  // mode plane of local plane j (the kernel_mode_index contract)
  const int lstride = lpow == 0 ? 1 : (lpow == 1 ? K1 : TM);
  const int s_lo = lstride == 1 ? K1 : 1, s_hi = lstride == TM ? K1 : TM;
  auto plane_of = [&](int j) {
    const int t = t0 + j / K1;
    return (long long)((j % K1) * lstride + (t % K1) * s_lo + (t / K1) * s_hi) * plane;
  };

  const int tid = threadIdx.x, nthr = blockDim.x;
  if (tid < tl) {
    const long long b = b0 + tid;
    s_cb[tid] = b < lines ? (b / inner) * outer_stride + (b % inner) : -1;
  }
  for (int i = tid; i < tg * NT; i += nthr) s_tab[i] = tab[t0 * NT + i];
  __syncthreads();

  // load, every copy in flight at once: dm (faces 0..n), l and alpha
  // (0..n-1, 0 at n); v and acc cell-fastest along each line for x, lines
  // fastest for z and y (nthr is a multiple of tl, so with lines fastest a
  // thread keeps its line). No division by n: the loops run over (plane,
  // cell), or a line comes from the multiply-shift divider.
  {
    const int t = tid & (tl - 1);
    const long long b = b0 + t, cb = s_cb[t];
    const bool live = cb >= 0;
    for (int i = tid; i < ((n + 1) << log_tl); i += nthr) {
      const int f = i >> log_tl;
      const long long o = live ? b + (long long)f * lines : 0;
      const bool in = live && f < n;
      copy_async(s_d + t * stride + f, dm + o, live);
      copy_async(s_l + t * stride + f, l + (in ? o : 0), in);
      copy_async(s_a + t * stride + f, alpha + (in ? o : 0), in);
    }
    if (!kLineMajor) {
      const int e0 = tid >> log_tl, de = nthr >> log_tl;
      for (int j = 0; j < np; ++j) {
        const long long base = plane_of(j) + cb;
        const int o = (j * tl + t) * stride;
        for (int e = e0; e < n; e += de) {
          const long long c = live ? base + (long long)e * cell_stride : 0;
          copy_async(s_v + o + e, v + c, live);
          copy_async(s_c + o + e, acc + c, live);
        }
      }
    }
  }
  if (kLineMajor) {
    for (int j = 0; j < np; ++j) {
      const long long base = plane_of(j);
      for (int i = tid; i < tl * n; i += nthr) {
        const int line = divn.div(i), e = i - line * n;
        const long long cb = s_cb[line];
        const bool ok = cb >= 0;
        const long long c = ok ? base + cb + (long long)e * cell_stride : 0;
        const int o = (j * tl + line) * stride + e;
        copy_async(s_v + o, v + c, ok);
        copy_async(s_c + o, acc + c, ok);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // the sweeps: thread (item = (t - t0)*tl + line, c) runs faces [s, e) of (t, line)
  {
    const int item = tid / ch, c = tid - item * ch;
    const int tq = item >> log_tl, line = item & (tl - 1);
    T bs0[K1], bs1[K1];
    const T* vr[K1];
#pragma unroll
    for (int i = 0; i < K1; ++i) {
      bs0[i] = s_tab[tq * NT + i];
      bs1[i] = s_tab[tq * NT + K1 + i];
      vr[i] = s_v + ((tq * K1 + i) * tl + line) * stride;
    }
    T* zr = s_z + item * stride;
    const T* dr = s_d + line * stride;
    const T* lr = s_l + line * stride;
    const int faces = n + 1;
    const int s = min(c * len, faces), e = min(s + len, faces);

    // forward, pass 1: (A, E) of the chunk, rf_f from v on the fly
    T vin[K1], vp[K1];
#pragma unroll
    for (int i = 0; i < K1; ++i) vin[i] = s > 0 && s < faces ? vr[i][s - 1] : T(0);
#pragma unroll
    for (int i = 0; i < K1; ++i) vp[i] = vin[i];
    T y = 0, A = 1;
#pragma unroll 4
    for (int f = s; f < e; ++f) {
      T rf = T(0);
#pragma unroll
      for (int i = 0; i < K1; ++i) rf += bs1[i] * vp[i];
      if (f < n) {
#pragma unroll
        for (int i = 0; i < K1; ++i) {
          vp[i] = vr[i][f];
          rf += bs0[i] * vp[i];
        }
      }
      const T a = f == 0 ? T(0) : -lr[f - 1];
      y = rf + a * y;
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
    // pass 2: z into the (t, line) row
    y = c == 0 ? T(0) : carry;
#pragma unroll
    for (int i = 0; i < K1; ++i) vp[i] = vin[i];
#pragma unroll 4
    for (int f = s; f < e; ++f) {
      T rf = T(0);
#pragma unroll
      for (int i = 0; i < K1; ++i) rf += bs1[i] * vp[i];
      if (f < n) {
#pragma unroll
        for (int i = 0; i < K1; ++i) {
          vp[i] = vr[i][f];
          rf += bs0[i] * vp[i];
        }
      }
      const T a = f == 0 ? T(0) : -lr[f - 1];
      y = rf + a * y;
      zr[f] = y;
    }

    // backward, pass 1 (this thread reads only the z it wrote)
    y = 0;
    A = 1;
#pragma unroll 4
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
#pragma unroll 4
    for (int f = e - 1; f >= s; --f) {
      const T a = f == n ? T(0) : -lr[f];
      y = zr[f] * dr[f] + a * y;
      zr[f] = y;
    }
  }
  __syncthreads();

  // store: acc of plane j = (t - t0)*K1 + lm, + bxo0*F_e + bxo1*F_{e+1} +
  // (sum_i q[lm][i] v_i)/alpha_e
  auto update = [&](int j, int line, int e) {
    const int tq = j / K1, lm = j - tq * K1;
    const T* row = s_tab + tq * NT;
    const T* F = s_z + (tq * tl + line) * stride;
    const T* vc = s_v + (tq * K1 * tl + line) * stride + e;
    T qv = T(0);
#pragma unroll
    for (int i = 0; i < K1; ++i) qv += row[4 * K1 + lm * K1 + i] * vc[i * tl * stride];
    return s_c[(j * tl + line) * stride + e] +
           (row[2 * K1 + lm] * F[e] + row[3 * K1 + lm] * F[e + 1] +
            qv / s_a[line * stride + e]);
  };
  if (kLineMajor) {
    for (int j = 0; j < np; ++j) {
      const long long base = plane_of(j);
      for (int i = tid; i < tl * n; i += nthr) {
        const int line = divn.div(i), e = i - line * n;
        const long long cb = s_cb[line];
        if (cb >= 0) acc[base + cb + (long long)e * cell_stride] = update(j, line, e);
      }
    }
  } else {
    const int line = tid & (tl - 1), e0 = tid >> log_tl, de = nthr >> log_tl;
    const long long cb = s_cb[line];
    if (cb >= 0) {
      for (int j = 0; j < np; ++j) {
        const long long base = plane_of(j) + cb;
        for (int e = e0; e < n; e += de)
          acc[base + (long long)e * cell_stride] = update(j, line, e);
      }
    }
  }
}

// Chunk length and row stride for (n, tl, ch) (as fused_rows.cu): len odd,
// so the chunk starts c*len of a warp's lanes fall in different banks; with
// several lines per warp (ch < 32) the row stride continues that pattern
// (stride = ch*len mod 32), with one line per warp it spreads the load's
// face rows (32/tl mod 32).
inline void tile_layout(int n, int tl, int ch, int* len, int* stride) {
  int ln = (n + 1 + ch - 1) / ch;
  if (ln % 2 == 0) ++ln;
  const int want = ch < 32 ? (ch * ln) % 32 : (tl < 32 ? 32 / tl : 1);
  int st = ch * ln;
  st += ((want - st) % 32 + 32) % 32;
  *len = ln;
  *stride = st;
}

template <typename T, int K1, bool kLineMajor>
int launch_k(void* acc, const void* v, const void* dm, const void* l, const void* alpha,
             const void* tab, int lpow, int n, long long lines, long long inner,
             long long outer_stride, long long cell_stride, long long plane, int log_tl,
             int ch, int tg, void* stream) {
  constexpr int TM = K1 * K1, NT = 4 * K1 + K1 * K1;
  const int tl = 1 << log_tl;
  if (TM % tg != 0) return (int)cudaErrorInvalidValue;
  int len, stride;
  tile_layout(n, tl, ch, &len, &stride);
  const size_t rows = (size_t)(tg * (2 * K1 + 1) + 3) * tl;
  const size_t bytes =
      (size_t)tl * sizeof(long long) + ((size_t)tg * NT + rows * stride) * sizeof(T);
  auto kernel = fused_ho_rows_kernel<T, K1, kLineMajor>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so a later launch does not report it
      return (int)err;
    }
  }
  const long long blocks = (lines + tl - 1) / tl * (TM / tg);
  kernel<<<(unsigned)blocks, tg * tl * ch, bytes, (cudaStream_t)stream>>>(
      (T*)acc, (const T*)v, (const T*)dm, (const T*)l, (const T*)alpha, (const T*)tab, lpow,
      n, lines, inner, outer_stride, cell_stride, plane, log_tl, ch, tg, len, stride,
      fast_div(n));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(void* acc, const void* v, const void* dm, const void* l, const void* alpha,
           const void* tab, int k1, int lpow, int n, long long lines, long long inner,
           long long outer_stride, long long cell_stride, long long plane, int tl, int ch,
           int tg, void* stream) {
  int log_tl = 0;
  while ((1 << log_tl) < tl) ++log_tl;
  const bool pow2 = (1 << log_tl) == tl && ch > 0 && (ch & (ch - 1)) == 0;
  if (!pow2 || ch > 32 || tl * ch < 32 || tg < 1 || tg * tl * ch > 1024 || n < 1 ||
      lpow < 0 || lpow > 2 || lines < 1 || (long long)tl * n >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const bool line_major = cell_stride == 1;
#define NEUTFEM_HO_ROWS(K, LM)                                                             \
  return launch_k<T, K, LM>(acc, v, dm, l, alpha, tab, lpow, n, lines, inner, outer_stride, \
                            cell_stride, plane, log_tl, ch, tg, stream)
  switch (k1) {
    case 2:
      if (line_major) NEUTFEM_HO_ROWS(2, true);
      NEUTFEM_HO_ROWS(2, false);
    case 3:
      if (line_major) NEUTFEM_HO_ROWS(3, true);
      NEUTFEM_HO_ROWS(3, false);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NEUTFEM_HO_ROWS
}

}  // namespace

// tl lines per block, ch chunks per (transverse mode, line), tg transverse
// modes per block: tl and ch powers of two, ch <= 32, tl*ch >= 32, tg a
// divisor of k1^2, tg*tl*ch <= 1024. A line's cells are contiguous
// (cell_stride 1: x) or neighbouring lines are (z, y); v and acc are staged
// accordingly.
extern "C" int neutfem_fused_ho_rows_f32(void* acc, const void* v, const void* dm,
                                         const void* l, const void* alpha, const void* tab,
                                         int k1, int lpow, int n, long long lines,
                                         long long inner, long long outer_stride,
                                         long long cell_stride, long long plane, int tl,
                                         int ch, int tg, void* stream) {
  return launch<float>(acc, v, dm, l, alpha, tab, k1, lpow, n, lines, inner, outer_stride,
                       cell_stride, plane, tl, ch, tg, stream);
}

extern "C" int neutfem_fused_ho_rows_f64(void* acc, const void* v, const void* dm,
                                         const void* l, const void* alpha, const void* tab,
                                         int k1, int lpow, int n, long long lines,
                                         long long inner, long long outer_stride,
                                         long long cell_stride, long long plane, int tl,
                                         int ch, int tg, void* stream) {
  return launch<double>(acc, v, dm, l, alpha, tab, k1, lpow, n, lines, inner, outer_stride,
                        cell_stride, plane, tl, ch, tg, stream);
}
