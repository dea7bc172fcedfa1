// Equilibration-folded RT0 Schur directions: the fused direction recurrence
// of csrc/fused_dir.cu with the symmetric Jacobi scaling of the CG's matvec
// (sdi * S(sdi * y), sdi = diag(S)^-1/2) folded into the loads and stores.
//
// Replaces the TPU kernels of neutfem_tpu/ops/pallas_fused.py (K7):
//   _fused_xT_eq  / _body_xT_eq   (x, mode 1): (ce*y + B A^-1 B^T u, u = sdi*y)
//   _fused_z_eq   / _body_z_eq    (z, mode 1): sdi*(acc + B A^-1 B^T u)
//   _fused_xT_eq2 / _body_xT_eq2  (x, mode 2): ce*y + B A^-1 B^T (sdi*y)
//   _fused_yT_eq2 / _body_yT_eq2  (y, mode 2): acc + B A^-1 B^T (sdi*y)
//   _fused_z_eq2  / _body_z_eq2   (z, mode 2): sdi*(acc + B A^-1 B^T (sdi*y))
// One kernel, fused_eq_kernel, serves all five through compile-time flags:
//   PRE     the recurrence runs on u = sdi*y, formed on load;
//   EMIT_U  u is written out (mode 1's x kernel, for the y and z kernels);
//   CE      out = ce*y + contribution, acc is not read (both x variants);
//   POST    out = sdi*(acc + contribution) (both z variants).
// The layouts and the line split are fused_dir_kernel's: line b is
// (outer, inner) = (b / inner, b % inner), its cells at
// outer*outer_stride + inner + e*cell_stride, its staged face operands
// (dm = dinv*mask, l) at b + f*lines; y, sdi, ce, u and acc are cell grids.
// The recurrence (f = face 0..n, e = cell 0..n-1, v the vector it runs on):
//   rF_f = bx1*v_{f-1} + bx0*v_f;  z_0 = rF_0*si;  z_f = rF_f*si - l_{f-1}*z_{f-1}
//   F_n = z_n*dm_n;  F_e = z_e*dm_e - l_e*F_{e+1};  contribution_e = bx0*F_e + bx1*F_{e+1}
// fused_dir_kernel itself is left as it is: sharing one body with another
// kernel slowed its ZION 48x48 launches from 621 to 688 us (NVIDIA H100 80GB
// HBM3, trace_solve --core zion2d), so K7 is its own kernel in its own file.
//
// Bound on this card: bytes, as K1-K3 (13-15 float operations per cell
// against 24-28 bytes). This version is latency-bound like them: one thread
// per line, ~2n dependent steps; the backward sweep reloads y (CE) and sdi
// (POST) at each cell, which the forward sweep has just brought into L2.

#include <cuda_runtime.h>

namespace {

enum : int { kPre = 1, kEmitU = 2, kCe = 4, kPost = 8 };

template <typename T, int FLAGS>
__global__ void fused_eq_kernel(T* __restrict__ acc, const T* __restrict__ y,
                                const T* __restrict__ sdi, const T* __restrict__ ce,
                                const T* __restrict__ dm, const T* __restrict__ l,
                                T* __restrict__ zs, T* __restrict__ u, int n, long long lines,
                                long long inner, long long outer_stride, long long cell_stride,
                                T bx0, T bx1, T si) {
  constexpr bool PRE = FLAGS & kPre, EMIT_U = FLAGS & kEmitU, CE = FLAGS & kCe,
                 POST = FLAGS & kPost;
  long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= lines) return;
  const long long cb = (b / inner) * outer_stride + (b % inner);

  // forward sweep over faces 0..n, on v = sdi*y (PRE) or y
  T v_prev = PRE ? y[cb] * sdi[cb] : y[cb];
  if (EMIT_U) u[cb] = v_prev;
  T z = (bx0 * v_prev) * si;
  zs[b] = z;
  for (int f = 1; f <= n; ++f) {
    T rf = bx1 * v_prev;
    if (f < n) {
      const long long c = cb + (long long)f * cell_stride;
      const T vf = PRE ? y[c] * sdi[c] : y[c];
      if (EMIT_U) u[c] = vf;
      rf = rf + bx0 * vf;
      v_prev = vf;
    }
    z = rf * si - l[b + (long long)(f - 1) * lines] * z;
    if (f < n) zs[b + (long long)f * lines] = z;
  }

  // backward sweep, emitting each cell as soon as F_e is known
  T f_next = z * dm[b + (long long)n * lines];
  for (int e = n - 1; e >= 0; --e) {
    const long long fo = b + (long long)e * lines;
    const T f_e = zs[fo] * dm[fo] - l[fo] * f_next;
    const long long c = cb + (long long)e * cell_stride;
    const T contrib = bx0 * f_e + bx1 * f_next;
    T out = CE ? ce[c] * y[c] + contrib : acc[c] + contrib;
    if (POST) out = sdi[c] * out;
    acc[c] = out;
    f_next = f_e;
  }
}

template <typename T, int FLAGS>
int launch(void* acc, const void* y, const void* sdi, const void* ce, const void* dm,
           const void* l, void* zs, void* u, int n, long long lines, long long inner,
           long long outer_stride, long long cell_stride, double bx0, double bx1, double si,
           void* stream) {
  const int threads = 128;
  const long long blocks = (lines + threads - 1) / threads;
  fused_eq_kernel<T, FLAGS><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (T*)acc, (const T*)y, (const T*)sdi, (const T*)ce, (const T*)dm, (const T*)l, (T*)zs,
      (T*)u, n, lines, inner, outer_stride, cell_stride, (T)bx0, (T)bx1, (T)si);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int flags, void* acc, const void* y, const void* sdi, const void* ce,
             const void* dm, const void* l, void* zs, void* u, int n, long long lines,
             long long inner, long long outer_stride, long long cell_stride, double bx0,
             double bx1, double si, void* stream) {
#define NEUTFEM_EQ_CASE(F)                                                                \
  case F:                                                                                 \
    return launch<T, F>(acc, y, sdi, ce, dm, l, zs, u, n, lines, inner, outer_stride,    \
                        cell_stride, bx0, bx1, si, stream);
  switch (flags) {
    NEUTFEM_EQ_CASE(kPre | kEmitU | kCe)  // x, mode 1
    NEUTFEM_EQ_CASE(kPost)                // z, mode 1
    NEUTFEM_EQ_CASE(kPre | kCe)           // x, mode 2
    NEUTFEM_EQ_CASE(kPre)                 // y, mode 2
    NEUTFEM_EQ_CASE(kPre | kPost)         // z, mode 2
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NEUTFEM_EQ_CASE
}

}  // namespace

extern "C" int neutfem_fused_eq_f32(int flags, void* acc, const void* y, const void* sdi,
                                    const void* ce, const void* dm, const void* l, void* zs,
                                    void* u, int n, long long lines, long long inner,
                                    long long outer_stride, long long cell_stride, double bx0,
                                    double bx1, double si, void* stream) {
  return dispatch<float>(flags, acc, y, sdi, ce, dm, l, zs, u, n, lines, inner, outer_stride,
                         cell_stride, bx0, bx1, si, stream);
}

extern "C" int neutfem_fused_eq_f64(int flags, void* acc, const void* y, const void* sdi,
                                    const void* ce, const void* dm, const void* l, void* zs,
                                    void* u, int n, long long lines, long long inner,
                                    long long outer_stride, long long cell_stride, double bx0,
                                    double bx1, double si, void* stream) {
  return dispatch<double>(flags, acc, y, sdi, ce, dm, l, zs, u, n, lines, inner, outer_stride,
                          cell_stride, bx0, bx1, si, stream);
}
