// Fused condensed Schur direction for k >= 1 (RT_k-P_k, K1 = k+1 longitudinal
// flux modes): acc += (B_d A_d^{-1} B_d^T + Qbub/alpha) v, one pass per
// (transverse mode, line).
//
// Replaces the TPU kernels of neutfem_tpu/ops/pallas_fused_ho.py (K6):
//   _fused_z_ho / _body_z_ho   (z direction, natural face layout)
//   _fused_y_ho / _body_y_ho   (y direction, solve-axis-major staging)
//   _fused_x_ho / _body_x_ho   (x direction, lane-packed staging on the TPU;
//                               here the unpadded (nx+1 / nx, nz*ny) layout)
// One kernel serves all three, with the stride scheme of fused_dir.cu: a line
// b splits as (b / inner, b % inner); its cells sit at outer*outer_stride +
// inner + e*cell_stride inside each mode plane, and its staged face operands
// (dm = dinv*mask, l, alpha) at b + f*lines, solve-axis-major.
//
// Mode index: the flux v is (P, nz, ny, nx) with P = K1^3 split as
// (K1[pz], K1[py], K1[px]), x fastest (the JAX reshape of the P axis). The
// longitudinal index l is the solve axis's own exponent, stride
// lstride = K1^lpow (x: 1, y: K1, z: K1^2); the transverse mode
// t = t_lo + K1*t_hi runs over the other two exponents, lower stride first.
// So z: p = l*K1^2 + t; y: p = t_z*K1^2 + l*K1 + t_x; x: p = t*K1 + l.
//
// Recurrence per (t, line), tables of row t (bxs = BXc/m_t, bxo = BXc, q = Qbub):
//   rf_f = sum_l bxs[1][l]*v[l][f-1] + bxs[0][l]*v[l][f]     (v out of range = 0)
//   z_0 = rf_0;  z_f = rf_f - l_{f-1}*z_{f-1}
//   F_n = z_n*dm_n;  F_e = z_e*dm_e - l_e*F_{e+1}
//   acc[l][e] += bxo[0][l]*F_e + bxo[1][l]*F_{e+1} + (sum_l' q[l][l']*v[l'][e]) / alpha_e
// Pinned faces carry l = 0 and dm = 0 (the context zeroes the off-diagonal
// before factoring), so no mask plane is streamed. Items of different t
// update disjoint mode planes of acc, so the in-place update is race-free.
//
// Bound on this card: per launch it streams v (twice), acc (read and write)
// and the three face operands once each -- bandwidth-bound in principle. This
// version is simple and latency-bound instead: one thread per (t, line) gives
// K1^2 x lines threads (26k-52k at RT2-P2 4x4x2, 76x76x38 cells), each
// walking ~2n dependent steps; the x direction's v and acc reads are strided
// by nx. Warp-cooperative or partitioned Thomas and shared-memory staging of
// the x lines are later work. The z scratch (T, n, lines) is solve-axis-major
// so its stores and loads coalesce; the coefficient table row (4*K1 + K1^2
// values) is read once per thread into registers.

#include <cuda_runtime.h>

namespace {

template <typename T, int K1>
__global__ void fused_ho_kernel(T* __restrict__ acc, const T* __restrict__ v,
                                const T* __restrict__ dm, const T* __restrict__ l,
                                const T* __restrict__ alpha, const T* __restrict__ tab,
                                T* __restrict__ zs, int lpow, int n, long long lines,
                                long long inner, long long outer_stride,
                                long long cell_stride, long long plane) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= lines) return;
  const int t = blockIdx.y;

  constexpr int NT = 4 * K1 + K1 * K1;
  T bxs0[K1], bxs1[K1], bxo0[K1], bxo1[K1], q[K1][K1];
  const T* row = tab + (long long)t * NT;
#pragma unroll
  for (int i = 0; i < K1; ++i) {
    bxs0[i] = row[i];
    bxs1[i] = row[K1 + i];
    bxo0[i] = row[2 * K1 + i];
    bxo1[i] = row[3 * K1 + i];
#pragma unroll
    for (int j = 0; j < K1; ++j) q[i][j] = row[4 * K1 + i * K1 + j];
  }

  const int lstride = lpow == 0 ? 1 : (lpow == 1 ? K1 : K1 * K1);
  const int s_lo = lstride == 1 ? K1 : 1;
  const int s_hi = lstride == K1 * K1 ? K1 : K1 * K1;
  const int tp = (t % K1) * s_lo + (t / K1) * s_hi;
  const long long cb = (b / inner) * outer_stride + (b % inner);
  const T* vp[K1];
  T* ap[K1];
#pragma unroll
  for (int i = 0; i < K1; ++i) {
    const long long off = (long long)(tp + i * lstride) * plane + cb;
    vp[i] = v + off;
    ap[i] = acc + off;
  }
  T* zt = zs + (long long)t * n * lines + b;

  // forward sweep over faces 0..n
  T v_prev[K1];
  T z = T(0);
#pragma unroll
  for (int i = 0; i < K1; ++i) {
    v_prev[i] = vp[i][0];
    z += bxs0[i] * v_prev[i];
  }
  zt[0] = z;
  for (int f = 1; f <= n; ++f) {
    T rf = T(0);
#pragma unroll
    for (int i = 0; i < K1; ++i) rf += bxs1[i] * v_prev[i];
    if (f < n) {
      const long long c = (long long)f * cell_stride;
#pragma unroll
      for (int i = 0; i < K1; ++i) {
        v_prev[i] = vp[i][c];
        rf += bxs0[i] * v_prev[i];
      }
    }
    z = rf - l[b + (long long)(f - 1) * lines] * z;
    if (f < n) zt[(long long)f * lines] = z;
  }

  // backward sweep, emitting each cell's K1 outputs as soon as F_e is known
  T f_next = z * dm[b + (long long)n * lines];
  for (int e = n - 1; e >= 0; --e) {
    const long long fo = b + (long long)e * lines;
    const T f_e = zt[(long long)e * lines] * dm[fo] - l[fo] * f_next;
    const T a = alpha[fo];
    const long long c = (long long)e * cell_stride;
    T ve[K1];
#pragma unroll
    for (int i = 0; i < K1; ++i) ve[i] = vp[i][c];
#pragma unroll
    for (int i = 0; i < K1; ++i) {
      T qv = T(0);
#pragma unroll
      for (int j = 0; j < K1; ++j) qv += q[i][j] * ve[j];
      ap[i][c] = ap[i][c] + (bxo0[i] * f_e + bxo1[i] * f_next + qv / a);
    }
    f_next = f_e;
  }
}

template <typename T, int K1>
int launch_k(void* acc, const void* v, const void* dm, const void* l, const void* alpha,
             const void* tab, void* zs, int lpow, int n, long long lines, long long inner,
             long long outer_stride, long long cell_stride, long long plane,
             void* stream) {
  const int threads = 128;
  const dim3 grid((unsigned)((lines + threads - 1) / threads), K1 * K1);
  fused_ho_kernel<T, K1><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (T*)acc, (const T*)v, (const T*)dm, (const T*)l, (const T*)alpha, (const T*)tab,
      (T*)zs, lpow, n, lines, inner, outer_stride, cell_stride, plane);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(void* acc, const void* v, const void* dm, const void* l, const void* alpha,
           const void* tab, void* zs, int k1, int lpow, int n, long long lines,
           long long inner, long long outer_stride, long long cell_stride, long long plane,
           void* stream) {
  if (lpow < 0 || lpow > 2) return (int)cudaErrorInvalidValue;
  switch (k1) {
    case 2:
      return launch_k<T, 2>(acc, v, dm, l, alpha, tab, zs, lpow, n, lines, inner,
                            outer_stride, cell_stride, plane, stream);
    case 3:
      return launch_k<T, 3>(acc, v, dm, l, alpha, tab, zs, lpow, n, lines, inner,
                            outer_stride, cell_stride, plane, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int neutfem_fused_ho_f32(void* acc, const void* v, const void* dm, const void* l,
                                    const void* alpha, const void* tab, void* zs, int k1,
                                    int lpow, int n, long long lines, long long inner,
                                    long long outer_stride, long long cell_stride,
                                    long long plane, void* stream) {
  return launch<float>(acc, v, dm, l, alpha, tab, zs, k1, lpow, n, lines, inner,
                       outer_stride, cell_stride, plane, stream);
}

extern "C" int neutfem_fused_ho_f64(void* acc, const void* v, const void* dm, const void* l,
                                    const void* alpha, const void* tab, void* zs, int k1,
                                    int lpow, int n, long long lines, long long inner,
                                    long long outer_stride, long long cell_stride,
                                    long long plane, void* stream) {
  return launch<double>(acc, v, dm, l, alpha, tab, zs, k1, lpow, n, lines, inner,
                        outer_stride, cell_stride, plane, stream);
}
