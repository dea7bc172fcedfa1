// Batched LDL^T tridiagonal solve along one axis, one thread per line.
//
// Replaces the TPU kernels of neutfem_tpu/ops/pallas_tridiag.py, dispatched by
// thomas_solve: _solve_z / _z_kernel (axis -3), _solve_rows / _rows_kernel
// (axis -2) and _solve_transpose / _transpose_kernel (axis -1) -- K4. The TPU
// needed three block layouts for its tiling; here one stride scheme serves
// every axis. The operands are contiguous with shape (outer, n, inner); a line
// b = (b / inner, b % inner) starts at (b / inner)*n*inner + b % inner and
// steps by inner (the multipliers l have n-1 entries per line).
//
//   forward:  z_0 = r_0;              z_i = r_i - l_{i-1} z_{i-1}
//   diagonal: x_{n-1} = z_{n-1} d_{n-1}
//   backward: x_i = z_i d_i - l_i x_{i+1}
//
// Bound on this card: it streams r, d, l in and x out (z round-trips through
// the output), so it is bandwidth-bound in principle; this simple version is
// latency-bound, like fused_dir.cu: ~13k-26k lines at the main path's shapes
// (rhs (2, 1, 77, 114, 114) and its y/x counterparts) fill a few percent of
// the card, and for the minor axis (inner = 1) neighbouring threads read
// addresses n apart. It runs once per solve, after the power iteration.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void thomas_kernel(const T* __restrict__ r, const T* __restrict__ d,
                              const T* __restrict__ l, T* __restrict__ out, int n,
                              long long lines, long long inner) {
  long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= lines) return;
  const long long o = b / inner, i = b % inner;
  const long long base = o * (long long)n * inner + i;
  const long long lbase = o * (long long)(n - 1) * inner + i;

  T z = r[base];
  out[base] = z;
  for (int k = 1; k < n; ++k) {
    z = r[base + (long long)k * inner] - l[lbase + (long long)(k - 1) * inner] * z;
    out[base + (long long)k * inner] = z;
  }
  T x = z * d[base + (long long)(n - 1) * inner];
  out[base + (long long)(n - 1) * inner] = x;
  for (int j = n - 2; j >= 0; --j) {
    const long long o_j = base + (long long)j * inner;
    x = out[o_j] * d[o_j] - l[lbase + (long long)j * inner] * x;
    out[o_j] = x;
  }
}

template <typename T>
int launch(const void* r, const void* d, const void* l, void* out, int n,
           long long lines, long long inner, void* stream) {
  const int threads = 128;
  const long long blocks = (lines + threads - 1) / threads;
  thomas_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)r, (const T*)d, (const T*)l, (T*)out, n, lines, inner);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int neutfem_thomas_f32(const void* r, const void* d, const void* l, void* out,
                                  int n, long long lines, long long inner, void* stream) {
  return launch<float>(r, d, l, out, n, lines, inner, stream);
}

extern "C" int neutfem_thomas_f64(const void* r, const void* d, const void* l, void* out,
                                  int n, long long lines, long long inner, void* stream) {
  return launch<double>(r, d, l, out, n, lines, inner, stream);
}

// Message for an error code returned by the launchers above.
extern "C" const char* neutfem_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
