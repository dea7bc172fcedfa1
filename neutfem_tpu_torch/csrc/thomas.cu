// Batched LDL^T tridiagonal solve along one axis: one thread per line (K4),
// and one block per 32 lines split into chunks for few, long lines (K4', below).
//
// K4 replaces the TPU kernels of neutfem_tpu/ops/pallas_tridiag.py, dispatched by
// thomas_solve: _solve_z / _z_kernel (axis -3), _solve_rows / _rows_kernel
// (axis -2) and _solve_transpose / _transpose_kernel (axis -1). The TPU
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

// K4': the same solve for few, long lines -- the TPU's _solve_y / _y_kernel
// (neutfem_tpu/ops/pallas_tridiag.py:197, :125), the 2D y solves: rhs
// (B, 1, 1, ny(+1), nx) along axis -2, e.g. 912 lines of 913 faces per group
// at ZION 48x48. One thread per line would leave most SMs idle and run ~2n
// dependent steps, so each line is split into CH chunks, one thread each;
// a block is 32 neighbouring lines (consecutive addresses: coalesced) x CH
// chunks. Both sweeps are first-order linear recurrences y_k = b_k + a_k y_prev:
//   pass 1: each chunk runs its recurrence from 0 and keeps its end value E
//           and the product A of its a_k;
//   carry:  the value entering chunk c is folded from the chunks before it
//           (carry' = E + A carry, CH steps through shared memory);
//   pass 2: each chunk reruns its recurrence from the true carry, writing.
// Forward a_k = -l_{k-1} (a_0 = 0), b_k = r_k; backward a_k = -l_k
// (a_{n-1} = 0), b_k = z_k d_k, chunks folded from the last. The dependent
// chain per thread is ~4n/CH + 2CH steps instead of 2n, for twice the reads.
template <typename T, int CH>
__global__ void thomas_wide_kernel(const T* __restrict__ r, const T* __restrict__ d,
                                   const T* __restrict__ l, T* __restrict__ out, int n,
                                   long long lines, long long inner) {
  __shared__ T s_a[CH][32], s_e[CH][32];
  const int lx = threadIdx.x, c = threadIdx.y;
  const long long b = (long long)blockIdx.x * 32 + lx;
  const bool live = b < lines;  // dead threads still take part in __syncthreads
  const long long o = live ? b / inner : 0, i = live ? b % inner : 0;
  const long long base = o * (long long)n * inner + i;
  const long long lbase = o * (long long)(n - 1) * inner + i;
  const int len = (n + CH - 1) / CH;
  const int s = min(c * len, n), e = min(s + len, n);

  // forward: z_k = r_k - l_{k-1} z_{k-1}
  T y = 0, A = 1;
  if (live) {
    for (int k = s; k < e; ++k) {
      const T a = k == 0 ? T(0) : -l[lbase + (long long)(k - 1) * inner];
      y = r[base + (long long)k * inner] + a * y;
      A *= a;
    }
  }
  s_a[c][lx] = A;
  s_e[c][lx] = y;
  __syncthreads();
  T carry = 0;
  for (int q = 0; q < c; ++q) carry = s_e[q][lx] + s_a[q][lx] * carry;
  y = carry;
  if (live) {
    for (int k = s; k < e; ++k) {
      const T a = k == 0 ? T(0) : -l[lbase + (long long)(k - 1) * inner];
      y = r[base + (long long)k * inner] + a * y;
      out[base + (long long)k * inner] = y;
    }
  }
  __syncthreads();  // every carry read before the backward pass reuses s_a, s_e

  // backward: x_k = z_k d_k - l_k x_{k+1}  (each chunk reads only its own z)
  y = 0;
  A = 1;
  if (live) {
    for (int k = e - 1; k >= s; --k) {
      const long long ok = base + (long long)k * inner;
      const T a = k == n - 1 ? T(0) : -l[lbase + (long long)k * inner];
      y = out[ok] * d[ok] + a * y;
      A *= a;
    }
  }
  s_a[c][lx] = A;
  s_e[c][lx] = y;
  __syncthreads();
  carry = 0;
  for (int q = CH - 1; q > c; --q) carry = s_e[q][lx] + s_a[q][lx] * carry;
  y = carry;
  if (live) {
    for (int k = e - 1; k >= s; --k) {
      const long long ok = base + (long long)k * inner;
      const T a = k == n - 1 ? T(0) : -l[lbase + (long long)k * inner];
      y = out[ok] * d[ok] + a * y;
      out[ok] = y;
    }
  }
}

constexpr int kWideChunks = 16;

template <typename T>
int launch_wide(const void* r, const void* d, const void* l, void* out, int n,
                long long lines, long long inner, void* stream) {
  const dim3 threads(32, kWideChunks);
  const long long blocks = (lines + 31) / 32;
  thomas_wide_kernel<T, kWideChunks><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)r, (const T*)d, (const T*)l, (T*)out, n, lines, inner);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int neutfem_thomas_wide_f32(const void* r, const void* d, const void* l, void* out,
                                       int n, long long lines, long long inner, void* stream) {
  return launch_wide<float>(r, d, l, out, n, lines, inner, stream);
}

extern "C" int neutfem_thomas_wide_f64(const void* r, const void* d, const void* l, void* out,
                                       int n, long long lines, long long inner, void* stream) {
  return launch_wide<double>(r, d, l, out, n, lines, inner, stream);
}

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
