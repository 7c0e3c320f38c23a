// The closed-form nonbond of ReaxFF over the pair list (vdW and shielded
// Coulomb, ref: pot.F90:702-773, init.F90:437-495) for Hopper (sm_90a),
// bound with ctypes.
//
// Replaces no TPU kernel: rxmd_tpu evaluates the pair list's nonbond
// (rxmd_tpu/reax.py `nonbond_cf_energy_forces` over the pair context) as
// XLA ops, and its one Pallas kernel is the cell-column sweep, which
// csrc/pairsweep.cu carries.  The port ran the same arithmetic as ~50
// PyTorch operations over (n, knb) planes (reax.cf_nonbond and
// reax._nonbond_rows): at 64,512 atoms knb is 704, so one float32 plane is
// 182 MB and the gathered parameter stack (n, knb, 6) 1.09 GB, and the row
// forces and the virial were einsums over them.  On an H100 that took 22
// ms of a 67-ms MD step at 64,512 atoms and 3.0 of 11.6 at 8,064.
// rxmd_tpu_torch/ops/nonbond_list.py wraps this kernel; its plain PyTorch
// version is `nonbond_list_plain` there, the planes themselves.
//
// nonbond_list_kernel computes in one pass over each center row of the
// nonbonded list what those planes gave: the row's vdW energy, its Coulomb
// energy, its force f_i = -sum ffac * dr and, for the strain virial, the
// products sum ffac * dr_a * dr_b, with ffac = (dE/dr)/r.  The list is
// full (each pair in both rows), so a row's force needs no other row's
// work: the kernel writes each output once, with no atomics, and the
// wrapper sums the rows' energy and virial parts in a fixed order (the
// 0.5 of each double-counted pair applied there), so the result does not
// depend on the schedule.
//
// Bound: bytes.  A row reads its knb int64 indices once: 45.4 M at 64,512
// atoms, 363 MB, ~0.11 ms at 3.35 TB/s.  The owners' positions, types and
// charges (under 2 MB) and the parameter table stay in L2 and shared
// memory.  The arithmetic, ~28 M pairs inside the taper of ~100 operations,
// is ~0.05 ms of float32 counted as operations, but two powers, an
// exponential, two square roots, a reciprocal cube root and two divisions
// a pair are each many instructions in their accurate forms, and each slot
// is a chain of dependent loads (the index, then the owner's position,
// type and charge).  So the design issues few instructions a pair and many
// loads at once: float32 takes the special-function unit's forms of the
// powers, the exponential, the cube root and the divisions (a few ulp
// each; the sums stay within ~1e-6 of the plain version's energies and
// ~1e-5 of the forces' rms, tests/test_torch_cuda.py), float64 the
// accurate ones; and each lane loads kUnroll slots' indices, then all
// their gathers, before any arithmetic.  (On an H100 the accurate float32
// forms took 35% longer, and 4 slots a lane 10% longer than 2.)
//
// Layout: one warp per center row, lanes striding coalesced over its knb
// slots; the (nso, nso, 6) closed-form table in shared memory, the center's
// row of it read by each pair; the gates of the planes (a live slot,
// r^2 <= rctap^2, the live center, not the atom itself, a pair type that
// exists); sums in registers and reduced by warp shuffles.  A ghost's
// position is pos[e % nown] + shift[e] @ H^T, the lattice shift read from
// the first entry of e's image block (every entry of a block shares it, as
// neighbors.make_image_table lays the table out).
//
// Every output is written by the kernel (rows with a dead center write
// zeros); it allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;          // center rows per block
constexpr int kUnroll = 2;         // slots a lane gathers before computing
constexpr int kPrm = 6;            // columns of cf_pair the closed form reads
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct NbArgs {
  const T* pos;                 // (N, 3) owner rows
  const T* H;                   // (3, 3) box
  const T* shift;               // (M, 3) lattice shift of each ext entry
  const long long* types;       // (N,)
  const long long* gid;         // (N,) global ids (a single image block)
  const unsigned char* amask;   // (N,) the live centers
  const long long* idxnb;       // (n, knb) nonbonded ext indices, -1 padded
  const T* q;                   // the centers' charges; the owners' (no qj)
  const T* qj;                  // (n, knb) the slots' charges, or null
  const T* cf_pair;             // (nso, nso, ncol) closed-form table
  const T* ctap;                // (8,) taper coefficients
  const T* rctap2;              // taper cutoff squared
  const T* pvdw1h;              // pvdW1 / 2
  const T* pvdw1inv;            // 1 / pvdW1
  int n, knb, nso, ncol, images;
  unsigned nown;                // the owner of ext entry e is e % nown
  T cclmb0;                     // Coulomb prefactor
  T* f;                         // (n, 3) row forces
  T* part;                      // (n, 2) or (n, 11): evdw, eclmb[, W 3x3]
};

// float32: the special-function unit's approximations; float64: accurate
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float exp_(float x) { return __expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float pow_(float x, float y) {
  return __powf(x, y);
}
__device__ __forceinline__ double pow_(double x, double y) {
  return pow(x, y);
}
__device__ __forceinline__ float rcbrt_(float x) {
  return __powf(x, -1.0f / 3.0f);
}
__device__ __forceinline__ double rcbrt_(double x) { return rcbrt(x); }
__device__ __forceinline__ float div_(float x, float y) {
  return __fdividef(x, y);
}
__device__ __forceinline__ double div_(double x, double y) { return x / y; }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T, bool kVir>
__global__ void __launch_bounds__(kWarps * 32)
nonbond_list_kernel(const NbArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* prm = reinterpret_cast<T*>(smem);
  for (int k = threadIdx.x; k < a.nso * a.nso * kPrm; k += blockDim.x)
    prm[k] = a.cf_pair[(size_t)(k / kPrm) * a.ncol + k % kPrm];
  __syncthreads();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + w;
  if (i >= a.n) return;                       // the whole warp
  // evdw, eclmb, f (3), then W's 00, 11, 22, 12, 20, 01
  T acc[11];
#pragma unroll
  for (int k = 0; k < 11; ++k) acc[k] = T(0);
  if (a.amask[i]) {
    const T pi[3] = {a.pos[3 * (size_t)i], a.pos[3 * (size_t)i + 1],
                     a.pos[3 * (size_t)i + 2]};
    const long long gi = a.images > 1 ? 0 : a.gid[i];
    const T qi = a.q[i];
    const T* prow = prm + a.types[i] * a.nso * kPrm;
    T Hm[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) Hm[k] = a.H[k];
    const T c0 = a.ctap[0], c4 = a.ctap[4], c5 = a.ctap[5], c6 = a.ctap[6],
            c7 = a.ctap[7];
    const T rc2 = *a.rctap2, p1h = *a.pvdw1h, p1inv = *a.pvdw1inv;
    const long long* row = a.idxnb + (size_t)i * a.knb;
    const T* qrow = a.qj == nullptr ? nullptr : a.qj + (size_t)i * a.knb;
    for (int cb = lane; cb < a.knb; cb += 32 * kUnroll) {
      long long e[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = cb + 32 * u;
        e[u] = c < a.knb ? row[c] : -1;
      }
      // every gather of the kUnroll slots before any arithmetic (a dead
      // slot reads entry 0's, which its gate drops)
      T pj[kUnroll][3], qv[kUnroll];
      int tj[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool live = e[u] >= 0;
        const unsigned eu = live ? (unsigned)e[u] : 0u;
        unsigned o = eu, base = 0u;
        if (a.images > 1) {
          o = eu % a.nown;
          base = eu - o;
        }
        const T s0 = __ldg(a.shift + 3 * (size_t)base),
                s1 = __ldg(a.shift + 3 * (size_t)base + 1),
                s2 = __ldg(a.shift + 3 * (size_t)base + 2);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          pj[u][k] =
              __ldg(a.pos + 3 * (size_t)o + k) +
              (s0 * Hm[3 * k] + s1 * Hm[3 * k + 1] + s2 * Hm[3 * k + 2]);
        tj[u] = (int)__ldg(a.types + o);
        const int c = live ? cb + 32 * u : 0;
        qv[u] = qrow == nullptr ? __ldg(a.q + o) : qrow[c];
        // not the atom itself: another owner across images, another global
        // id within one image block
        const bool other =
            a.images > 1 ? o != (unsigned)i : __ldg(a.gid + o) != gi;
        ok[u] = live && other;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!ok[u]) continue;
        const T d0 = pi[0] - pj[u][0], d1 = pi[1] - pj[u][1],
                d2 = pi[2] - pj[u][2];
        const T r2 = d0 * d0 + d1 * d1 + d2 * d2;
        if (!(r2 <= rc2)) continue;
        const T* p = prow + tj[u] * kPrm;
        if (!(p[0] > T(0.5))) continue;
        // taper and its r-derivative / r (ref: init.F90:437-439)
        const T dr1 = sqrt_(r2);
        const T dr3 = dr1 * r2, dr4 = r2 * r2, dr5 = dr1 * dr4,
                dr6 = r2 * dr4, dr7 = dr1 * dr6;
        const T tap = c7 * dr7 + c6 * dr6 + c5 * dr5 + c4 * dr4 + c0;
        const T dtap = T(7) * c7 * dr5 + T(6) * c6 * dr4 + T(5) * c5 * dr3 +
                       T(4) * c4 * r2;
        // vdW with inner-wall shielding and shielded Coulomb (ref:
        // init.F90:440-495)
        const T alpha = p[2], rvdwi = p[3], dij = p[4];
        const T vd1 = pow_(r2, p1h);
        const T base = vd1 + p[1];
        const T fn13 = pow_(base, p1inv);
        const T exp1 = exp_(alpha * (T(1) - fn13 * rvdwi));
        const T exp2 = sqrt_(exp1);
        const T g3 = rcbrt_(dr3 + p[5]);
        const T dfn13 = div_(fn13, base) * div_(vd1, r2);
        const T ev = tap * dij * (exp1 - T(2) * exp2);
        const T ec = tap * a.cclmb0 * g3;
        const T dev = dij * (dtap * (exp1 - T(2) * exp2) -
                             tap * (alpha * rvdwi) * (exp1 - exp2) * dfn13);
        const T dec = a.cclmb0 * g3 * (dtap - g3 * g3 * g3 * tap * dr1);
        const T qq = qi * qv[u];
        const T ff = dev + dec * qq;
        acc[0] += ev;
        acc[1] += ec * qq;
        acc[2] -= ff * d0;
        acc[3] -= ff * d1;
        acc[4] -= ff * d2;
        if (kVir) {
          acc[5] += ff * d0 * d0;
          acc[6] += ff * d1 * d1;
          acc[7] += ff * d2 * d2;
          acc[8] += ff * d1 * d2;
          acc[9] += ff * d2 * d0;
          acc[10] += ff * d0 * d1;
        }
      }
    }
  }
  constexpr int kAcc = kVir ? 11 : 5;
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = warp_sum(acc[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) a.f[3 * (size_t)i + k] = acc[2 + k];
    T* out = a.part + (size_t)i * (kVir ? 11 : 2);
    out[0] = acc[0];
    out[1] = acc[1];
    if (kVir) {
      // the symmetric 3x3, row-major
      const T wv[9] = {acc[5], acc[10], acc[9], acc[10], acc[6],
                       acc[8], acc[9],  acc[8], acc[7]};
#pragma unroll
      for (int k = 0; k < 9; ++k) out[2 + k] = wv[k];
    }
  }
}

template <typename T>
int launch(const NbArgs<T>& a, int with_virial, cudaStream_t stream) {
  if (a.n == 0) return 0;
  const dim3 grid((a.n + kWarps - 1) / kWarps), block(kWarps * 32);
  const size_t smem = sizeof(T) * a.nso * a.nso * kPrm;
  if (with_virial)
    nonbond_list_kernel<T, true><<<grid, block, smem, stream>>>(a);
  else
    nonbond_list_kernel<T, false><<<grid, block, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int entry(int with_virial, const void* pos, const void* H, const void* shift,
          const void* types, const void* gid, const void* amask,
          const void* idxnb, const void* q, const void* qj,
          const void* cf_pair, const void* ctap, const void* rctap2,
          const void* pvdw1h, const void* pvdw1inv, int n, int knb, int nso,
          int ncol, int images, long long nown, double cclmb0, void* f,
          void* part, void* stream) {
  NbArgs<T> a;
  a.pos = (const T*)pos;
  a.H = (const T*)H;
  a.shift = (const T*)shift;
  a.types = (const long long*)types;
  a.gid = (const long long*)gid;
  a.amask = (const unsigned char*)amask;
  a.idxnb = (const long long*)idxnb;
  a.q = (const T*)q;
  a.qj = (const T*)qj;
  a.cf_pair = (const T*)cf_pair;
  a.ctap = (const T*)ctap;
  a.rctap2 = (const T*)rctap2;
  a.pvdw1h = (const T*)pvdw1h;
  a.pvdw1inv = (const T*)pvdw1inv;
  a.n = n;
  a.knb = knb;
  a.nso = nso;
  a.ncol = ncol;
  a.images = images;
  a.nown = (unsigned)nown;
  a.cclmb0 = (T)cclmb0;
  a.f = (T*)f;
  a.part = (T*)part;
  return launch(a, with_virial, (cudaStream_t)stream);
}

}  // namespace

// dtype 0: float32, 1: float64; qj null: the owners' charges q[e % nown]
extern "C" int rxmd_nonbond_list(
    int dtype, int with_virial, const void* pos, const void* H,
    const void* shift, const void* types, const void* gid, const void* amask,
    const void* idxnb, const void* q, const void* qj, const void* cf_pair,
    const void* ctap, const void* rctap2, const void* pvdw1h,
    const void* pvdw1inv, int n, int knb, int nso, int ncol, int images,
    long long nown, double cclmb0, void* f, void* part, void* stream) {
  if (dtype)
    return entry<double>(with_virial, pos, H, shift, types, gid, amask, idxnb,
                         q, qj, cf_pair, ctap, rctap2, pvdw1h, pvdw1inv, n,
                         knb, nso, ncol, images, nown, cclmb0, f, part,
                         stream);
  return entry<float>(with_virial, pos, H, shift, types, gid, amask, idxnb, q,
                      qj, cf_pair, ctap, rctap2, pvdw1h, pvdw1inv, n, knb,
                      nso, ncol, images, nown, cclmb0, f, part, stream);
}

extern "C" const char* rxmd_nonbond_list_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
