// Forms of the QEq apply, for measurement only (scripts/qeq_apply_forms.py):
// the port runs rxmd_tpu_torch/csrc/pairsweep.cu's qeq_apply_kernel.  All
// read the same list (records rec[start[i] : start[i] + count[i]], each
// (owner code, bits of h)) and write the same (3, nrows) rows.
//   mode 0: as qeq_apply_kernel, L lanes a row, U record pairs a lane
//           loaded before the first gather, gathers from global memory;
//   mode 1: the records alone (h summed, no gather): the list's stream;
//   mode 2: as mode 0, but the (n, 2) state and q staged once into each
//           block's shared memory and the rows taken in a grid-stride loop.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <int L, int U, int kMode>
__device__ __forceinline__ void row_sums(
    int i, int sub, const int* start, const int* count, const int2* rec,
    const float2* x, const float* qv, int T, int cap, float& a0, float& a1,
    float& a2) {
  int e0 = 0, e1 = 0;
  if (i < T) {
    e0 = start[i];
    e1 = min(e0 + count[i], cap);
  }
  const int4* rec4 = reinterpret_cast<const int4*>(rec);
  for (int p = (e0 & ~1) + 2 * sub; p < e1; p += 2 * L * U) {
    int4 r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pu = p + 2 * L * u;
      r[u] = make_int4(0, 0, 0, 0);
      if (pu < e1) {
        if (pu + 1 < cap) {
          r[u] = __ldg(rec4 + (pu >> 1));
        } else {
          const int2 w = __ldg(rec + pu);
          r[u].x = w.x;
          r[u].y = w.y;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int pe = p + 2 * L * u + k;
        const bool ok = pe >= e0 && pe < e1;
        const int c = k ? r[u].z : r[u].x;
        const float h = ok ? __int_as_float(k ? r[u].w : r[u].y) : 0.f;
        if (kMode == 1) {
          a0 += h;
          a1 += h * static_cast<float>(c & 1);
          continue;
        }
        const int o = c >= 0 ? c : ~c;
        const float2 xo = ok ? x[o] : make_float2(0.f, 0.f);
        const float qo = ok ? qv[o] : 0.f;
        a0 += h * xo.x;
        a1 += h * xo.y;
        a2 += h * ((c >= 0 ? 1.f : 0.5f) * qo);
      }
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    a0 += __shfl_xor_sync(kFull, a0, off);
    a1 += __shfl_xor_sync(kFull, a1, off);
    a2 += __shfl_xor_sync(kFull, a2, off);
  }
}

template <int L, int U, int kMode>
__global__ void __launch_bounds__(128) apply_global(
    const int* start, const int* count, const int2* rec, const int* trow,
    const float2* x, const float* qv, float* out, int T, int nrows,
    int cap) {
  const int i = (blockIdx.x * 128 + threadIdx.x) / L;
  const int sub = threadIdx.x & (L - 1);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  row_sums<L, U, kMode>(i, sub, start, count, rec, x, qv, T, cap, a0, a1,
                        a2);
  if (sub == 0 && i < T) {
    const int row = trow[i];
    out[row] = a0;
    out[nrows + row] = a1;
    out[2 * static_cast<size_t>(nrows) + row] = a2;
  }
}

template <int L, int U>
__global__ void __launch_bounds__(512, 2) apply_shared(
    const int* start, const int* count, const int2* rec, const int* trow,
    const float2* x, const float* qv, float* out, int T, int nrows, int cap,
    int n) {
  extern __shared__ float2 xs[];
  float* qs = reinterpret_cast<float*>(xs + n);
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    xs[k] = x[k];
    qs[k] = qv[k];
  }
  __syncthreads();
  const int per = blockDim.x / L;
  const int sub = threadIdx.x & (L - 1);
  for (int b = blockIdx.x * per; b < T; b += gridDim.x * per) {
    const int i = b + threadIdx.x / L;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    row_sums<L, U, 0>(i, sub, start, count, rec, xs, qs, T, cap, a0, a1,
                      a2);
    if (sub == 0 && i < T) {
      const int row = trow[i];
      out[row] = a0;
      out[nrows + row] = a1;
      out[2 * static_cast<size_t>(nrows) + row] = a2;
    }
  }
}

template <int L, int U, int kMode>
int run_global(const int* start, const int* count, const int* rec,
               const int* trow, const float* x, const float* q, float* out,
               int T, int nrows, int cap, cudaStream_t st) {
  const int blocks = (T * L + 127) / 128;
  apply_global<L, U, kMode><<<blocks, 128, 0, st>>>(
      start, count, reinterpret_cast<const int2*>(rec), trow,
      reinterpret_cast<const float2*>(x), q, out, T, nrows, cap);
  return static_cast<int>(cudaGetLastError());
}

template <int L, int U>
int run_shared(const int* start, const int* count, const int* rec,
               const int* trow, const float* x, const float* q, float* out,
               int T, int nrows, int cap, int n, int blocks,
               cudaStream_t st) {
  const size_t smem = 12 * static_cast<size_t>(n);
  cudaError_t err = cudaFuncSetAttribute(
      apply_shared<L, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  apply_shared<L, U><<<blocks, 512, smem, st>>>(
      start, count, reinterpret_cast<const int2*>(rec), trow,
      reinterpret_cast<const float2*>(x), q, out, T, nrows, cap, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// form: 0 (L32 U4), 1 (L32 U2), 2 (L32 U8), 3 (L16 U4), 4 (records only,
// L32 U4), 5 (shared memory, L32 U4), 6 (shared memory, L16 U4), 7 (L8
// U4).
extern "C" int apply_form(int form, const int* start, const int* count,
                          const int* rec, const int* trow, const float* x,
                          const float* q, float* out, int T, int nrows,
                          int cap, int n, int blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (form) {
    case 0: return run_global<32, 4, 0>(start, count, rec, trow, x, q, out,
                                        T, nrows, cap, st);
    case 1: return run_global<32, 2, 0>(start, count, rec, trow, x, q, out,
                                        T, nrows, cap, st);
    case 2: return run_global<32, 8, 0>(start, count, rec, trow, x, q, out,
                                        T, nrows, cap, st);
    case 3: return run_global<16, 4, 0>(start, count, rec, trow, x, q, out,
                                        T, nrows, cap, st);
    case 4: return run_global<32, 4, 1>(start, count, rec, trow, x, q, out,
                                        T, nrows, cap, st);
    case 5: return run_shared<32, 4>(start, count, rec, trow, x, q, out, T,
                                     nrows, cap, n, blocks, st);
    case 6: return run_shared<16, 4>(start, count, rec, trow, x, q, out, T,
                                     nrows, cap, n, blocks, st);
    case 7: return run_global<8, 4, 0>(start, count, rec, trow, x, q, out,
                                       T, nrows, cap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
