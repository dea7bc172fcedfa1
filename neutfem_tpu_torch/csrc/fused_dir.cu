// Fused RT0 Schur direction: acc += B_d A_d^{-1} B_d^T v, one pass per line.
//
// Replaces the TPU kernels of neutfem_tpu/ops/pallas_fused.py:
//   _fused_z  / _body_z   (z direction, natural face layout)       -- K1
//   _fused_yT / _body_yT  (y direction, solve-axis-major staging)  -- K2
//   _fused_xT / _body_xT  (x direction, pre-transposed staging)    -- K3
// One kernel serves all three: a line b is split as (outer, inner) =
// (b / inner, b % inner); its cells sit at outer*outer_stride + inner +
// e*cell_stride, and its staged face operands (dm = dinv*mask, l) at
// b + f*lines, solve-axis-major, so neighbouring threads read neighbouring
// face entries.
//
// Recurrence along the line (f = face 0..n, e = cell 0..n-1):
//   rF_f = bx1*v_{f-1} + bx0*v_f                  (v out of range = 0)
//   z_0 = rF_0*si;  z_f = rF_f*si - l_{f-1}*z_{f-1}
//   F_n = z_n*dm_n; F_e = z_e*dm_e - l_e*F_{e+1}
//   acc_e += bx0*F_e + bx1*F_{e+1}
// si = 1/m_t is a scalar: pinned faces already have l = 0 and dm = 0 in the
// context, so the mask plane of the rhs is redundant (see pallas_fused.py).
// z_0..z_{n-1} go to a caller-allocated scratch (n, lines), solve-axis-major,
// so its stores and loads coalesce.
//
// Bound on this card: it streams v, acc (read and write), dm and l once, so
// it is bandwidth-bound in principle. This version is simple and
// latency-bound instead: one thread per line gives only 8,664 lines for x
// and y and 12,996 for z at IAEA-3D 6x6x4 (76x114x114 cells), a few percent
// of the H100's resident-thread capacity, each walking ~2n dependent steps;
// and the x direction's v and acc reads are strided by nx (one line per
// thread, the solve axis contiguous). Making it fast (warp-cooperative or
// partitioned Thomas, shared-memory staging of the x lines) is later work.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void fused_dir_kernel(T* __restrict__ acc, const T* __restrict__ v,
                                 const T* __restrict__ dm, const T* __restrict__ l,
                                 T* __restrict__ zs, int n, long long lines,
                                 long long inner, long long outer_stride,
                                 long long cell_stride, T bx0, T bx1, T si) {
  long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= lines) return;
  const long long cb = (b / inner) * outer_stride + (b % inner);

  // forward sweep over faces 0..n
  T v_prev = v[cb];
  T z = (bx0 * v_prev) * si;
  zs[b] = z;
  for (int f = 1; f <= n; ++f) {
    T rf = bx1 * v_prev;
    if (f < n) {
      const T vf = v[cb + (long long)f * cell_stride];
      rf = rf + bx0 * vf;
      v_prev = vf;
    }
    z = rf * si - l[b + (long long)(f - 1) * lines] * z;
    if (f < n) zs[b + (long long)f * lines] = z;
  }

  // backward sweep, emitting each cell's divergence as soon as F_e is known
  T f_next = z * dm[b + (long long)n * lines];
  for (int e = n - 1; e >= 0; --e) {
    const long long fo = b + (long long)e * lines;
    const T f_e = zs[fo] * dm[fo] - l[fo] * f_next;
    const long long c = cb + (long long)e * cell_stride;
    acc[c] = acc[c] + (bx0 * f_e + bx1 * f_next);
    f_next = f_e;
  }
}

template <typename T>
int launch(void* acc, const void* v, const void* dm, const void* l, void* zs, int n,
           long long lines, long long inner, long long outer_stride,
           long long cell_stride, double bx0, double bx1, double si, void* stream) {
  const int threads = 128;
  const long long blocks = (lines + threads - 1) / threads;
  fused_dir_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (T*)acc, (const T*)v, (const T*)dm, (const T*)l, (T*)zs, n, lines, inner,
      outer_stride, cell_stride, (T)bx0, (T)bx1, (T)si);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int neutfem_fused_dir_f32(void* acc, const void* v, const void* dm,
                                     const void* l, void* zs, int n, long long lines,
                                     long long inner, long long outer_stride,
                                     long long cell_stride, double bx0, double bx1,
                                     double si, void* stream) {
  return launch<float>(acc, v, dm, l, zs, n, lines, inner, outer_stride, cell_stride,
                       bx0, bx1, si, stream);
}

extern "C" int neutfem_fused_dir_f64(void* acc, const void* v, const void* dm,
                                     const void* l, void* zs, int n, long long lines,
                                     long long inner, long long outer_stride,
                                     long long cell_stride, double bx0, double bx1,
                                     double si, void* stream) {
  return launch<double>(acc, v, dm, l, zs, n, lines, inner, outer_stride, cell_stride,
                        bx0, bx1, si, stream);
}
