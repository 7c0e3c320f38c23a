// Cell-column nonbonded pair sweeps for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel rxmd_tpu/ops/pairsweep.py `_sweep` (the one
// pl.pallas_call, pairsweep.py:289) with its two pair bodies,
// `make_nonbond_pair_fn.pair_fn` (closed-form vdW + shielded Coulomb with
// the 7th-order taper: energies, row forces, pair virial) and
// `make_qeq_pair_fn.pair_fn` (QEq hessian applied to hs and ht, plus the
// Est pair sum).  The plain PyTorch version of the same function is
// rxmd_tpu_torch/ops/pairsweep.py `sweep_plain`.
//
// Design (the simple, correct first form):
//   * one CTA per (target column, z-block), one thread per target slot
//     (C = 128); each thread keeps its out_k row sums in registers and
//     writes its own output row: row ownership, no atomics, no scatter;
//   * per stencil column the CTA stages that column's z-window of the K
//     input planes (K * Wp floats, ~6.6 KB at Wp = 208) in shared memory,
//     cooperatively and coalesced, then every thread walks the window;
//   * the (nso, nso, P) type-pair table and the taper coefficients sit in
//     shared memory, indexed by int(type) (the TPU kernel's one-hot MXU
//     products become table lookups);
//   * windows are the exact reach of the block, clamped into the column;
//     the TPU's 128-lane rounding of the window start is a Mosaic rule
//     that does not apply here.
//
// What bounds it: arithmetic, not bytes.  Every slot of every window is
// tested, padded target slots included (pad-pair inflation: at 8,064
// atoms 756 blocks x 128 x 69 columns x 208 slots = 1.39e9 candidates per
// sweep for 1.14e7 directed pairs inside the taper radius; the TPU's
// 384-slot windows made it 2.5e9), and each accepted pair costs
// powf/expf/sqrtf.  Sub-tile culling (skip window tiles whose bounding
// box is beyond the cutoff) and half-shell schemes (Newton's third law,
// which needs a reduction across blocks) are later work.

#include <cuda_runtime.h>

namespace {

struct Geom {
  int npc, n_zb, ncols, C, Wp, nzc, zoff0, zlo_rel, nso, nslots;
  float rc2;
};

__device__ __forceinline__ int type_index(float t, int nso) {
  int i = static_cast<int>(t);
  return i < 0 ? 0 : (i >= nso ? nso - 1 : i);
}

__device__ __forceinline__ void taper(const float* ct, float dr2, float dr1,
                                      float& tap, float& dtap) {
  const float dr3 = dr1 * dr2, dr4 = dr2 * dr2, dr5 = dr1 * dr4;
  const float dr6 = dr2 * dr4, dr7 = dr1 * dr6;
  tap = ct[7] * dr7 + ct[6] * dr6 + ct[5] * dr5 + ct[4] * dr4 + ct[0];
  dtap = 7.f * ct[7] * dr5 + 6.f * ct[6] * dr4 + 5.f * ct[5] * dr3 +
         4.f * ct[4] * dr2;
}

// planes: 0:x 1:y 2:z 3:type 4:gid 5:q
// rows:   evdw eclmb fx fy fz w_xx w_yy w_zz w_yz w_zx w_xy
struct NonbondPair {
  static constexpr int K = 6, OUT = 11, P = 6;
  float pvdW1h, pvdW1inv, cclmb;

  __device__ __forceinline__ void operator()(
      const float* r, const float* win, int Wp, int j, const float* tbl,
      const float* ct, const Geom& g, float* acc) const {
    const float dx = r[0] - win[j];
    const float dy = r[1] - win[Wp + j];
    const float dz = r[2] - win[2 * Wp + j];
    const float dr2 = dx * dx + dy * dy + dz * dz;
    if (!(dr2 <= g.rc2 && dr2 > 1e-6f)) return;
    if (r[4] == win[4 * Wp + j]) return;       // same gid (ref: pot.F90:715)
    const float* pr = tbl + (type_index(r[3], g.nso) * g.nso +
                             type_index(win[3 * Wp + j], g.nso)) * P;
    if (!(pr[0] > 0.5f)) return;
    const float dr1 = sqrtf(dr2);
    float tap, dtap;
    taper(ct, dr2, dr1, tap, dtap);
    const float rij_vd1 = powf(dr2, pvdW1h);
    const float gw = rij_vd1 + pr[1];
    const float fn13 = powf(gw, pvdW1inv);
    const float exp1 = expf(pr[2] * (1.f - fn13 * pr[3]));
    const float exp2 = sqrtf(exp1);
    const float dr3gam = powf(dr1 * dr2 + pr[5], -1.f / 3.f);
    const float qq = r[5] * win[5 * Wp + j];
    const float evdw = tap * pr[4] * (exp1 - 2.f * exp2);
    const float eclmb = tap * cclmb * dr3gam * qq;
    // (dE/dr)/r, ref: pot.F90:736-761
    const float dfn13 = fn13 / gw * (rij_vd1 / dr2);
    const float devdw = pr[4] * (dtap * (exp1 - 2.f * exp2) -
                                 tap * (pr[2] * pr[3]) * (exp1 - exp2) * dfn13);
    const float declmb =
        cclmb * dr3gam * (dtap - dr3gam * dr3gam * dr3gam * tap * dr1) * qq;
    const float ff = devdw + declmb;
    acc[0] += 0.5f * evdw;
    acc[1] += 0.5f * eclmb;
    acc[2] -= ff * dx;
    acc[3] -= ff * dy;
    acc[4] -= ff * dz;
    acc[5] -= 0.5f * ff * dx * dx;
    acc[6] -= 0.5f * ff * dy * dy;
    acc[7] -= 0.5f * ff * dz * dz;
    acc[8] -= 0.5f * ff * dy * dz;
    acc[9] -= 0.5f * ff * dz * dx;
    acc[10] -= 0.5f * ff * dx * dy;
  }
};

// planes: 0:x 1:y 2:z 3:type 4:is_primary 5:hs 6:ht 7:q
// rows:   H.hs  H.ht  est_pair (weight 1.0 primary, 0.5 image)
struct QeqPair {
  static constexpr int K = 8, OUT = 3, P = 2;
  float cclmb_qeq;

  __device__ __forceinline__ void operator()(
      const float* r, const float* win, int Wp, int j, const float* tbl,
      const float* ct, const Geom& g, float* acc) const {
    const float dx = r[0] - win[j];
    const float dy = r[1] - win[Wp + j];
    const float dz = r[2] - win[2 * Wp + j];
    const float dr2 = dx * dx + dy * dy + dz * dz;
    if (!(dr2 <= g.rc2 && dr2 > 1e-6f)) return;
    const float* pr = tbl + (type_index(r[3], g.nso) * g.nso +
                             type_index(win[3 * Wp + j], g.nso)) * P;
    if (!(pr[0] > 0.5f)) return;
    const float dr1 = sqrtf(dr2);
    float tap, dtap;
    taper(ct, dr2, dr1, tap, dtap);
    const float hess = cclmb_qeq * tap * powf(dr1 * dr2 + pr[1], -1.f / 3.f);
    const float w = win[4 * Wp + j] > 0.5f ? 1.f : 0.5f;
    acc[0] += hess * win[5 * Wp + j];
    acc[1] += hess * win[6 * Wp + j];
    acc[2] += hess * w * win[7 * Wp + j];
  }
};

template <class Pair>
__global__ void __launch_bounds__(128) sweep_kernel(
    const float* __restrict__ packed, const int* __restrict__ col_base,
    const int* __restrict__ coloffs, const float* __restrict__ table,
    const float* __restrict__ ctap, float* __restrict__ out, Geom g,
    Pair pair) {
  extern __shared__ float smem[];
  float* win = smem;                                // K * Wp window planes
  float* tbl = smem + Pair::K * g.Wp;               // nso * nso * P
  float* ct = tbl + g.nso * g.nso * Pair::P;        // 8 taper coefficients
  const int blk = blockIdx.x;                       // p * n_zb + zb
  const int p = blk / g.n_zb;
  const int zb = blk - p * g.n_zb;
  const int tid = threadIdx.x;

  for (int i = tid; i < g.nso * g.nso * Pair::P; i += blockDim.x)
    tbl[i] = table[i];
  if (tid < 8) ct[tid] = ctap[tid];

  const int base = col_base[p];
  const int tslot = base + g.zlo_rel + zb * g.C + tid;
  float r[Pair::K];
#pragma unroll
  for (int k = 0; k < Pair::K; ++k)
    r[k] = packed[static_cast<size_t>(k) * g.nslots + tslot];
  float acc[Pair::OUT];
#pragma unroll
  for (int o = 0; o < Pair::OUT; ++o) acc[o] = 0.f;

  for (int s = 0; s < g.ncols; ++s) {
    const int nb = base + coloffs[s];
    int ws = nb + g.zoff0 + zb * g.C;
    ws = max(nb, min(ws, nb + g.nzc - g.Wp));
    __syncthreads();              // the previous window is consumed
    for (int i = tid; i < Pair::K * g.Wp; i += blockDim.x) {
      const int k = i / g.Wp;
      win[i] = packed[static_cast<size_t>(k) * g.nslots + ws + (i - k * g.Wp)];
    }
    __syncthreads();
    for (int j = 0; j < g.Wp; ++j) pair(r, win, g.Wp, j, tbl, ct, g, acc);
  }

  const size_t ntg = static_cast<size_t>(gridDim.x) * g.C;
  const size_t t = static_cast<size_t>(blk) * g.C + tid;
#pragma unroll
  for (int o = 0; o < Pair::OUT; ++o) out[o * ntg + t] = acc[o];
}

template <class Pair>
int launch(const float* packed, const int* col_base, const int* coloffs,
           const float* table, const float* ctap, float* out, const Geom& g,
           const Pair& pair, cudaStream_t stream) {
  if (g.C != 128) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (Pair::K * g.Wp + g.nso * g.nso * Pair::P + 8);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sweep_kernel<Pair>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sweep_kernel<Pair><<<g.npc * g.n_zb, g.C, smem, stream>>>(
      packed, col_base, coloffs, table, ctap, out, g, pair);
  return static_cast<int>(cudaGetLastError());
}

Geom make_geom(int npc, int n_zb, int ncols, int C, int Wp, int nzc,
               int zoff0, int zlo_rel, int nso, int nslots, float rc2) {
  Geom g;
  g.npc = npc; g.n_zb = n_zb; g.ncols = ncols; g.C = C; g.Wp = Wp;
  g.nzc = nzc; g.zoff0 = zoff0; g.zlo_rel = zlo_rel; g.nso = nso;
  g.nslots = nslots; g.rc2 = rc2;
  return g;
}

}  // namespace

// Each entry launches on `stream` and returns the cudaError_t of the
// launch (0 on success); it does not synchronise.
extern "C" int pairsweep_nonbond(
    const float* packed, const int* col_base, const int* coloffs,
    const float* table, const float* ctap, float* out, int npc, int n_zb,
    int ncols, int C, int Wp, int nzc, int zoff0, int zlo_rel, int nso,
    int nslots, float rc2, float pvdW1h, float pvdW1inv, float cclmb,
    void* stream) {
  NonbondPair pair{pvdW1h, pvdW1inv, cclmb};
  return launch(packed, col_base, coloffs, table, ctap, out,
                make_geom(npc, n_zb, ncols, C, Wp, nzc, zoff0, zlo_rel, nso,
                          nslots, rc2),
                pair, static_cast<cudaStream_t>(stream));
}

extern "C" int pairsweep_qeq(
    const float* packed, const int* col_base, const int* coloffs,
    const float* table, const float* ctap, float* out, int npc, int n_zb,
    int ncols, int C, int Wp, int nzc, int zoff0, int zlo_rel, int nso,
    int nslots, float rc2, float cclmb_qeq, void* stream) {
  QeqPair pair{cclmb_qeq};
  return launch(packed, col_base, coloffs, table, ctap, out,
                make_geom(npc, n_zb, ncols, C, Wp, nzc, zoff0, zlo_rel, nso,
                          nslots, rc2),
                pair, static_cast<cudaStream_t>(stream));
}

extern "C" const char* pairsweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
