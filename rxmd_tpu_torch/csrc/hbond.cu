// The hydrogen-bond term of ReaxFF for Hopper (sm_90a), bound with ctypes.
//
// Replaces no TPU kernel: rxmd_tpu evaluates the uncached hydrogen bonds
// (rxmd_tpu/reax.py `e_hbond`) as XLA ops over a dense (donor, H slot,
// acceptor slot) grid and takes their forces with jax.grad.  The port did
// the same with torch.autograd (rxmd_tpu_torch/reax.py `e_hbond`, grid
// mode), and on an H100 that grid took 29 ms of a 56-ms MD step at 8,064
// atoms: 34.1 M lanes of which ~6% are live, each gathering its parameters,
// its types and both ghost positions, and autograd keeping every
// intermediate for an index_add backward.
//
// hbond_kernel computes in one pass over each donor's nonbonded row what
// that grid's forward and backward gave (ref: pot.F90:587-665): the energy,
// its gradient with respect to the positions, to each donor-H bond order
// BO0 and, for the strain virial, to the box H.  rxmd_tpu_torch/ops/hbond.py
// wraps it in a torch.autograd.Function whose backward scales the saved
// gradients; dE/dBO0 flows on through the bond order's autograd graph.  The
// plain PyTorch version of the same function is `hbond_plain` there.
//
// Bound: bytes.  A donor with hydrogens reads its row of the nonbonded list
// (knb int64 indices) once; positions, types, shifts and the parameter
// tables stay in the 50 MB L2.  At 8,064 atoms that is ~5,200 rows of 704
// indices, ~29 MB: ~9 us at 3.35 TB/s.  The arithmetic, ~2 M live
// (donor, H, acceptor) entries of ~150 operations, is ~5 us at 67 TFLOP/s.
// What sets the pace is each slot's chain of dependent loads (the index,
// the owner's type, the type table, the position and shift): the design
// keeps many warps in flight and gates before any arithmetic.
//
// Layout: one warp per donor row.  A row without a hydrogen slot exits after
// one read of its (kb,) hydrogen mask.  The donor's hydrogens, up to kMaxH
// a pass (a donor with more takes further passes over its row), sit in
// shared memory: position, r_ij, |r_ij|, BO0 and ext index.  Lanes stride
// coalesced over the row's knb slots and gate on the acceptor's type
// (inxn3hb[ti, H, tk] >= 0, one row of the table per donor, through the
// read-only cache), then on |r_i - r_k|^2 < RCHB2, summed with rounding at
// every step as the plain version sums it, so both keep the same entries.
// Reductions: each lane sums its entries' energy, donor gradient, and each
// hydrogen's gradient and dE/dBO0 in registers; shuffles reduce them per
// warp.  Lane 0 writes dE/dBO0 (one writer per (donor, slot), no atomics)
// and adds the donor's and each hydrogen's gradient with one atomic add a
// component; each acceptor slot adds its gradient, summed over the donor's
// hydrogens, with one atomic add a component into the (N, 3) gradient.  The
// donor's energy goes to its own slot of an (n,) buffer, summed afterwards,
// so the energy does not depend on the order of atomics.  dE/dH (only when
// the caller asks: the virial) is summed per lane, reduced per warp, and
// added with nine atomics a warp.
//
// Every output buffer is zeroed by the wrapper; the kernel allocates
// nothing and launches on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;          // donor rows per block
constexpr int kMaxH = 4;           // hydrogens a pass over the row
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct HbArgs {
  const T* pos;                 // (N, 3) owner rows
  const T* H;                   // (3, 3) box
  const T* shift;               // (M, 3) lattice shift of each ext entry
  const long long* types;       // (N,)
  const long long* idxb;        // (n, kb) bonded ext indices
  const unsigned char* hmask;   // (n, kb) the donor's hydrogen slots
  const T* bo0;                 // (n, kb) BO0 of each bonded slot
  const long long* idxnb;       // (n, knb) nonbonded ext indices, -1 padded
  const long long* inxn3hb;     // (nso, nso, nso) hbond type, -1 for none
  const T* hbprm;               // (nhbty, 4): r0, phb1, phb2, phb3
  int n, kb, knb, nso, h_type;
  long long nown;               // the owner row of ext entry e is e % nown
  T rchb2, cos_bound;
  T* e_part;                    // (n,) energy by donor
  T* gpos;                      // (N, 3) dE/dpos
  T* gbo;                       // (n, kb) dE/dBO0
  T* gH;                        // (3, 3) dE/dH
};

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }

// (x*x + y*y) + z*z with every step rounded (no fused multiply-add), as
// the plain version sums it
template <typename T>
__device__ __forceinline__ T dist2(T x, T y, T z) {
  return add_rn(add_rn(mul_rn(x, x), mul_rn(y, y)), mul_rn(z, z));
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// position of ext entry e: its owner's row plus shift @ H^T; s its shift
template <typename T>
__device__ __forceinline__ void ghost(const HbArgs<T>& a, const T Hm[9],
                                      long long e, T p[3], T s[3]) {
  const long long o = e % a.nown;
#pragma unroll
  for (int c = 0; c < 3; ++c) s[c] = __ldg(a.shift + 3 * e + c);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    p[c] = __ldg(a.pos + 3 * o + c) +
           (s[0] * Hm[3 * c] + s[1] * Hm[3 * c + 1] + s[2] * Hm[3 * c + 2]);
}

template <typename T, bool kDH>
__global__ void __launch_bounds__(kWarps * 32)
hbond_kernel(const HbArgs<T> a) {
  __shared__ T sh_pj[kWarps][kMaxH][3];
  __shared__ T sh_rij[kWarps][kMaxH][3];
  __shared__ T sh_nij[kWarps][kMaxH];
  __shared__ T sh_bo[kWarps][kMaxH];
  __shared__ long long sh_j[kWarps][kMaxH];
  __shared__ int sh_slot[kWarps][kMaxH];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + w;
  if (i >= a.n) return;                       // the whole warp
  const unsigned char* hm = a.hmask + (size_t)i * a.kb;
  const T pi[3] = {a.pos[3 * (size_t)i], a.pos[3 * (size_t)i + 1],
                   a.pos[3 * (size_t)i + 2]};
  const long long* hbrow =
      a.inxn3hb + (a.types[i] * a.nso + a.h_type) * a.nso;
  const long long* row = a.idxnb + (size_t)i * a.knb;
  const T bound = a.cos_bound;
  T Hm[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) Hm[q] = a.H[q];
  T e = T(0), gi[3] = {T(0), T(0), T(0)};
  T dh[9];                                  // dE/dH (kDH)
#pragma unroll
  for (int q = 0; q < 9; ++q) dh[q] = T(0);
  bool any = false;
  int s_next = 0, base = 0;
  unsigned pending = 0u;
  for (;;) {
    // the next (up to kMaxH) hydrogen slots, in slot order
    int nh = 0;
    while (nh < kMaxH) {
      if (pending == 0u) {
        if (s_next >= a.kb) break;
        const int s = s_next + lane;
        pending = __ballot_sync(kFull, s < a.kb && hm[s]);
        base = s_next;
        s_next += 32;
        continue;
      }
      const int b = __ffs(pending) - 1;
      pending &= pending - 1u;
      if (lane == 0) sh_slot[w][nh] = base + b;
      ++nh;
    }
    if (nh == 0) break;
    any = true;
    __syncwarp();
    if (lane < nh) {
      const int s = sh_slot[w][lane];
      const long long j = a.idxb[(size_t)i * a.kb + s];
      T pj[3], sj[3];
      ghost(a, Hm, j, pj, sj);
      T r[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        sh_pj[w][lane][c] = pj[c];
        r[c] = pi[c] - pj[c];
        sh_rij[w][lane][c] = r[c];
      }
      sh_nij[w][lane] = sqrt_(r[0] * r[0] + r[1] * r[1] + r[2] * r[2]);
      sh_bo[w][lane] = a.bo0[(size_t)i * a.kb + s];
      sh_j[w][lane] = j;
    }
    __syncwarp();

    T gj[kMaxH][3], gb[kMaxH];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      gj[h][0] = gj[h][1] = gj[h][2] = gb[h] = T(0);
    }
    for (int c = lane; c < a.knb; c += 32) {
      const long long k = row[c];
      if (k < 0) continue;
      const long long ko = k % a.nown;
      const int t = (int)__ldg(hbrow + __ldg(a.types + ko));
      if (t < 0) continue;
      T pk[3], sk[3];
      ghost(a, Hm, k, pk, sk);
      if (!(dist2(pi[0] - pk[0], pi[1] - pk[1], pi[2] - pk[2]) < a.rchb2))
        continue;
      T r0 = __ldg(a.hbprm + 4 * t);
      const T p1 = __ldg(a.hbprm + 4 * t + 1), p2 = __ldg(a.hbprm + 4 * t + 2),
              p3 = __ldg(a.hbprm + 4 * t + 3);
      if (!(r0 > T(0))) r0 = T(1);
      const T ir0 = T(1) / r0;
      T gk[3] = {T(0), T(0), T(0)};
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) {
        if (h >= nh || sh_j[w][h] == k) continue;     // j != k
        T rij[3], rjk[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          rij[q] = sh_rij[w][h][q];
          rjk[q] = sh_pj[w][h][q] - pk[q];
        }
        const T nij = sh_nij[w][h];
        const T njk2 = rjk[0] * rjk[0] + rjk[1] * rjk[1] + rjk[2] * rjk[2];
        const T njk = sqrt_(njk2);
        const T dot = rij[0] * rjk[0] + rij[1] * rjk[1] + rij[2] * rjk[2];
        const T cs = -dot / (nij * njk);
        const T cc = cs < -bound ? -bound : (cs > bound ? bound : cs);
        const T half = (T(1) - cc) * T(0.5);          // sin^2(theta/2)
        const T s4 = half * half;
        const T e2 = exp_(-p2 * sh_bo[w][h]);
        const T e3 = exp_(-p3 * (r0 / njk + njk * ir0 - T(2)));
        const T amp = p1 * (T(1) - e2) * e3;
        const T eh = amp * s4;
        e += eh;
        gb[h] += p1 * p2 * e2 * e3 * s4;
        // dE/dcos (0 where the clamp holds cos) and dE/d|r_jk|/|r_jk|
        const T dc = (cs >= -bound && cs <= bound) ? -amp * half : T(0);
        const T dn = eh * (-p3) * (ir0 - r0 / njk2) / njk;
        const T inv = T(1) / (nij * njk);
        const T ci = cs / (nij * nij), ck = cs / njk2;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          // cos = -rij.rjk / (|rij||rjk|); u = rij = ri - rj, v = rjk = rj - rk
          const T du = dc * (-rjk[q] * inv - ci * rij[q]);
          const T dv = dc * (-rij[q] * inv - ck * rjk[q]) + dn * rjk[q];
          gi[q] += du;
          gj[h][q] += dv - du;
          gk[q] -= dv;
        }
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        atomicAdd(a.gpos + 3 * ko + q, gk[q]);
        if (kDH) {
#pragma unroll
          for (int b = 0; b < 3; ++b) dh[3 * q + b] += gk[q] * sk[b];
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      if (h >= nh) break;                             // nh: the warp's own
      const T g0 = warp_sum(gj[h][0]), g1 = warp_sum(gj[h][1]),
              g2 = warp_sum(gj[h][2]), gbh = warp_sum(gb[h]);
      if (lane == 0) {
        a.gbo[(size_t)i * a.kb + sh_slot[w][h]] = gbh;
        const long long j = sh_j[w][h];
        const long long jo = j % a.nown;
        atomicAdd(a.gpos + 3 * jo, g0);
        atomicAdd(a.gpos + 3 * jo + 1, g1);
        atomicAdd(a.gpos + 3 * jo + 2, g2);
        if (kDH) {
          const T g[3] = {g0, g1, g2};
#pragma unroll
          for (int q = 0; q < 3; ++q)
#pragma unroll
            for (int b = 0; b < 3; ++b)
              dh[3 * q + b] += g[q] * __ldg(a.shift + 3 * j + b);
        }
      }
    }
    __syncwarp();                 // the next pass rewrites shared memory
  }
  if (!any) return;
  e = warp_sum(e);
#pragma unroll
  for (int q = 0; q < 3; ++q) gi[q] = warp_sum(gi[q]);
  if (lane == 0) {
    a.e_part[i] = e;
#pragma unroll
    for (int q = 0; q < 3; ++q) atomicAdd(a.gpos + 3 * (size_t)i + q, gi[q]);
  }
  if (kDH) {
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const T v = warp_sum(dh[q]);
      if (lane == 0) atomicAdd(a.gH + q, v);
    }
  }
}

template <typename T>
int launch(const HbArgs<T>& a, int want_dh, cudaStream_t stream) {
  if (a.n == 0) return 0;
  const dim3 grid((a.n + kWarps - 1) / kWarps), block(kWarps * 32);
  if (want_dh)
    hbond_kernel<T, true><<<grid, block, 0, stream>>>(a);
  else
    hbond_kernel<T, false><<<grid, block, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int entry(const void* pos, const void* H, const void* shift, const void* types,
          const void* idxb, const void* hmask, const void* bo0,
          const void* idxnb, const void* inxn3hb, const void* hbprm, int n,
          int kb, int knb, int nso, int h_type, long long nown, double rchb2,
          double cos_bound, void* e_part, void* gpos, void* gbo, void* gH,
          void* stream) {
  HbArgs<T> a;
  a.pos = (const T*)pos;
  a.H = (const T*)H;
  a.shift = (const T*)shift;
  a.types = (const long long*)types;
  a.idxb = (const long long*)idxb;
  a.hmask = (const unsigned char*)hmask;
  a.bo0 = (const T*)bo0;
  a.idxnb = (const long long*)idxnb;
  a.inxn3hb = (const long long*)inxn3hb;
  a.hbprm = (const T*)hbprm;
  a.n = n;
  a.kb = kb;
  a.knb = knb;
  a.nso = nso;
  a.h_type = h_type;
  a.nown = nown;
  a.rchb2 = (T)rchb2;
  a.cos_bound = (T)cos_bound;
  a.e_part = (T*)e_part;
  a.gpos = (T*)gpos;
  a.gbo = (T*)gbo;
  a.gH = (T*)gH;
  return launch(a, gH != nullptr, (cudaStream_t)stream);
}

}  // namespace

// dtype 0: float32, 1: float64; gH null: no dE/dH
extern "C" int rxmd_hbond(int dtype, const void* pos, const void* H,
                          const void* shift, const void* types,
                          const void* idxb, const void* hmask, const void* bo0,
                          const void* idxnb, const void* inxn3hb,
                          const void* hbprm, int n, int kb, int knb, int nso,
                          int h_type, long long nown, double rchb2,
                          double cos_bound, void* e_part, void* gpos,
                          void* gbo, void* gH, void* stream) {
  if (dtype)
    return entry<double>(pos, H, shift, types, idxb, hmask, bo0, idxnb,
                         inxn3hb, hbprm, n, kb, knb, nso, h_type, nown, rchb2,
                         cos_bound, e_part, gpos, gbo, gH, stream);
  return entry<float>(pos, H, shift, types, idxb, hmask, bo0, idxnb, inxn3hb,
                      hbprm, n, kb, knb, nso, h_type, nown, rchb2, cos_bound,
                      e_part, gpos, gbo, gH, stream);
}

extern "C" const char* rxmd_hbond_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
