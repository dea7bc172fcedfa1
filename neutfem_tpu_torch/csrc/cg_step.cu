// The masked PCG step's elementwise and scalar work (krylov._pcg_parts.step)
// in two launches around the matvec and the preconditioner:
//
//   cg_step_xr  after q = A p and pq = <p, q>:
//       breakdown = |pq| <= tiny;  alpha = go && !breakdown ? rz / pq : 0
//       x' = x + alpha p;  r' = r - alpha q;  [rr = r' * r', the product vector]
//   cg_step_p   after z = M r' and the dots rz' = <r', z>, rr' = <r', r'>:
//       beta = go ? rz' / (rz == 0 ? 1 : rz) : 0;  p' = z + beta p
//       one thread: rz'' = go ? rz' : rz;  rr'' = go ? rr' : rr;  it' = it + go;
//                   go' = go && !breakdown && rr'' > tol_sq && it' < maxiter
//
// Replaces no TPU kernel: the JAX package's step is one XLA fusion inside its
// while_loop.  On the card the same step ran as ~29 ATen launches an
// iteration, ~20 of them on 0-d tensors (each a launch's fixed cost); these
// two read the 0-d operands from device memory in every thread, so the step
// stays capturable in krylov.CGGraph and needs no host read.
//
// Bit for bit the ATen step: every product, sum and quotient is rounded on
// its own (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, the __d*_rn forms
// at float64), so x + alpha p is round(x + round(alpha p)) as the two ATen
// launches gave it, with no FMA contraction; the selects keep torch.where's
// semantics (a rz of 0 or -0 reads as 1; |pq| <= tiny is false for a NaN).
// The dots stay outside (torch.sum over the same product vectors), so their
// reduction order and the sharded all-reduce are unchanged.
//
// Bound on this card: bytes.  cg_step_xr reads x, p, q, r and writes x', r'
// (and rr): 7 n words, 6 n without rr; cg_step_p reads z, p and writes p':
// 3 n words.  The ATen step moved 17 n (15 n without rr).  Flat over n =
// numel, so one kernel serves every shape (a group's flux, the Jacobi
// sweep's batch, CMFD's cell vector, a rank's slab) and both dtypes.
//
// Design: a grid-stride loop of 16-byte loads and stores (four floats or two
// doubles) where every vector pointer is 16-byte aligned, then a scalar tail;
// one value at a time otherwise.  No atomics, no shared memory.  The 0-d state is
// written by thread 0 of block 0 to tensors the wrapper made for it, never
// into an input that other blocks still read.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

__device__ __forceinline__ bool breakdown(const float* pq) {
  return fabsf(*pq) <= FLT_MIN;  // torch.finfo(torch.float32).tiny
}
__device__ __forceinline__ bool breakdown(const double* pq) { return fabs(*pq) <= DBL_MIN; }

// 16 bytes of T, loaded and stored as one vector access where aligned
template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T s[N];
};

// x' = x + a p;  r' = r - a q;  rr = r' r'
template <typename T, bool RR>
__device__ __forceinline__ void xr_one(T a, T x, T r, T p, T q, T& xo, T& ro, T& rr) {
  xo = add_rn(x, mul_rn(a, p));
  ro = sub_rn(r, mul_rn(a, q));
  if (RR) rr = mul_rn(ro, ro);
}

template <typename T, bool RR, bool VEC>
__global__ void cg_step_xr_kernel(const T* __restrict__ x, const T* __restrict__ r,
                                  const T* __restrict__ p, const T* __restrict__ q,
                                  T* __restrict__ xo, T* __restrict__ ro, T* __restrict__ rr,
                                  long long n, const T* pq, const T* rz, const bool* go) {
  const T a = (*go && !breakdown(pq)) ? div_rn(*rz, *pq) : T(0);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long head = 0;
  if (VEC) {
    using V = Vec<T>;
    constexpr int N = V::N;
    const long long nv = n / N;
    for (long long v = t; v < nv; v += stride) {
      const V xv = reinterpret_cast<const V*>(x)[v], rv = reinterpret_cast<const V*>(r)[v];
      const V pv = reinterpret_cast<const V*>(p)[v], qv = reinterpret_cast<const V*>(q)[v];
      V xw, rw, sw;
#pragma unroll
      for (int k = 0; k < N; ++k)
        xr_one<T, RR>(a, xv.s[k], rv.s[k], pv.s[k], qv.s[k], xw.s[k], rw.s[k], sw.s[k]);
      reinterpret_cast<V*>(xo)[v] = xw;
      reinterpret_cast<V*>(ro)[v] = rw;
      if (RR) reinterpret_cast<V*>(rr)[v] = sw;
    }
    head = nv * N;
  }
  for (long long i = head + t; i < n; i += stride) {
    T s;
    xr_one<T, RR>(a, x[i], r[i], p[i], q[i], xo[i], ro[i], s);
    if (RR) rr[i] = s;
  }
}

template <typename T, bool VEC>
__global__ void cg_step_p_kernel(const T* __restrict__ z, const T* __restrict__ p,
                                 T* __restrict__ po, long long n, const T* pq, const T* rz,
                                 const T* rz_new, const T* rr_new, const T* rr, const int* it,
                                 const bool* go, const void* tol_sq, int tol_f64,
                                 long long maxiter, T* rz_out, T* rr_out, int* it_out,
                                 bool* go_out) {
  const bool live = *go;
  const T rz0 = *rz, rz1 = *rz_new;
  const T beta = live ? div_rn(rz1, rz0 == T(0) ? T(1) : rz0) : T(0);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t == 0) {
    const T rr1 = live ? *rr_new : *rr;
    const int it1 = *it + (live ? 1 : 0);
    // rr > tol_sq as torch compares them: in the wider of the two dtypes
    const double tol = tol_f64 ? *static_cast<const double*>(tol_sq)
                               : (double)*static_cast<const float*>(tol_sq);
    *rz_out = live ? rz1 : rz0;
    *rr_out = rr1;
    *it_out = it1;
    *go_out = live && !breakdown(pq) && (double)rr1 > tol && (long long)it1 < maxiter;
  }
  long long head = 0;
  if (VEC) {
    using V = Vec<T>;
    constexpr int N = V::N;
    const long long nv = n / N;
    for (long long v = t; v < nv; v += stride) {
      const V zv = reinterpret_cast<const V*>(z)[v], pv = reinterpret_cast<const V*>(p)[v];
      V w;
#pragma unroll
      for (int k = 0; k < N; ++k) w.s[k] = add_rn(zv.s[k], mul_rn(beta, pv.s[k]));
      reinterpret_cast<V*>(po)[v] = w;
    }
    head = nv * N;
  }
  for (long long i = head + t; i < n; i += stride) po[i] = add_rn(z[i], mul_rn(beta, p[i]));
}

bool aligned16(const void* ptr) { return ptr == nullptr || (uintptr_t)ptr % 16 == 0; }

// Blocks of 256 threads, at most 8 a streaming multiprocessor (one full wave
// of resident threads), at least one so thread 0 always writes the 0-d state.
unsigned grid(long long work) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  long long blocks = (work + 255) / 256;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

template <typename T>
int launch_xr(const void* x, const void* r, const void* p, const void* q, void* xo, void* ro,
              void* rr, long long n, const void* pq, const void* rz, const void* go,
              void* stream) {
  const bool vec = aligned16(x) && aligned16(r) && aligned16(p) && aligned16(q) &&
                   aligned16(xo) && aligned16(ro) && aligned16(rr);
  const unsigned blocks = grid(vec ? n / Vec<T>::N : n);
  cudaStream_t s = (cudaStream_t)stream;
  const T *xt = (const T*)x, *rt = (const T*)r, *pt = (const T*)p, *qt = (const T*)q;
  T *xd = (T*)xo, *rd = (T*)ro, *sd = (T*)rr;
  const T *pqt = (const T*)pq, *rzt = (const T*)rz;
  const bool* gt = (const bool*)go;
  if (rr != nullptr) {
    if (vec)
      cg_step_xr_kernel<T, true, true><<<blocks, 256, 0, s>>>(xt, rt, pt, qt, xd, rd, sd, n, pqt,
                                                                rzt, gt);
    else
      cg_step_xr_kernel<T, true, false><<<blocks, 256, 0, s>>>(xt, rt, pt, qt, xd, rd, sd, n,
                                                                 pqt, rzt, gt);
  } else {
    if (vec)
      cg_step_xr_kernel<T, false, true><<<blocks, 256, 0, s>>>(xt, rt, pt, qt, xd, rd, sd, n,
                                                                 pqt, rzt, gt);
    else
      cg_step_xr_kernel<T, false, false><<<blocks, 256, 0, s>>>(xt, rt, pt, qt, xd, rd, sd, n,
                                                                  pqt, rzt, gt);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_p(const void* z, const void* p, void* po, long long n, const void* pq, const void* rz,
             const void* rz_new, const void* rr_new, const void* rr, const void* it,
             const void* go, const void* tol_sq, int tol_f64, long long maxiter, void* rz_out,
             void* rr_out, void* it_out, void* go_out, void* stream) {
  const bool vec = aligned16(z) && aligned16(p) && aligned16(po);
  const unsigned blocks = grid(vec ? n / Vec<T>::N : n);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    cg_step_p_kernel<T, true><<<blocks, 256, 0, s>>>(
        (const T*)z, (const T*)p, (T*)po, n, (const T*)pq, (const T*)rz, (const T*)rz_new,
        (const T*)rr_new, (const T*)rr, (const int*)it, (const bool*)go, tol_sq, tol_f64,
        maxiter, (T*)rz_out, (T*)rr_out, (int*)it_out, (bool*)go_out);
  else
    cg_step_p_kernel<T, false><<<blocks, 256, 0, s>>>(
        (const T*)z, (const T*)p, (T*)po, n, (const T*)pq, (const T*)rz, (const T*)rz_new,
        (const T*)rr_new, (const T*)rr, (const int*)it, (const bool*)go, tol_sq, tol_f64,
        maxiter, (T*)rz_out, (T*)rr_out, (int*)it_out, (bool*)go_out);
  return (int)cudaGetLastError();
}

}  // namespace

// x, r, p, q, xo, ro, rr (NULL: no product vector), n, pq, rz, go, stream
extern "C" int neutfem_cg_xr_f32(const void* x, const void* r, const void* p, const void* q,
                                 void* xo, void* ro, void* rr, long long n, const void* pq,
                                 const void* rz, const void* go, void* stream) {
  return launch_xr<float>(x, r, p, q, xo, ro, rr, n, pq, rz, go, stream);
}

extern "C" int neutfem_cg_xr_f64(const void* x, const void* r, const void* p, const void* q,
                                 void* xo, void* ro, void* rr, long long n, const void* pq,
                                 const void* rz, const void* go, void* stream) {
  return launch_xr<double>(x, r, p, q, xo, ro, rr, n, pq, rz, go, stream);
}

// z, p, po, n, pq, rz, rz_new, rr_new, rr, it, go, tol_sq, tol_f64, maxiter,
// rz_out, rr_out, it_out, go_out, stream
extern "C" int neutfem_cg_p_f32(const void* z, const void* p, void* po, long long n,
                                const void* pq, const void* rz, const void* rz_new,
                                const void* rr_new, const void* rr, const void* it,
                                const void* go, const void* tol_sq, int tol_f64,
                                long long maxiter, void* rz_out, void* rr_out, void* it_out,
                                void* go_out, void* stream) {
  return launch_p<float>(z, p, po, n, pq, rz, rz_new, rr_new, rr, it, go, tol_sq, tol_f64,
                         maxiter, rz_out, rr_out, it_out, go_out, stream);
}

extern "C" int neutfem_cg_p_f64(const void* z, const void* p, void* po, long long n,
                                const void* pq, const void* rz, const void* rz_new,
                                const void* rr_new, const void* rr, const void* it,
                                const void* go, const void* tol_sq, int tol_f64,
                                long long maxiter, void* rz_out, void* rr_out, void* it_out,
                                void* go_out, void* stream) {
  return launch_p<double>(z, p, po, n, pq, rz, rz_new, rr_new, rr, it, go, tol_sq, tol_f64,
                          maxiter, rz_out, rr_out, it_out, go_out, stream);
}
