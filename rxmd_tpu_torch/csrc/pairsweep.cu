// Cell-walk nonbonded pair kernels for Hopper (sm_90a), bound with ctypes.
//
// Replace the TPU kernel rxmd_tpu/ops/pairsweep.py `_sweep` (:231-295, the
// one pl.pallas_call at :289) with its two pair bodies:
//   nonbond_kernel      `make_nonbond_pair_fn.pair_fn` (:355-423): vdW +
//                       shielded Coulomb with the 7th-order taper, energies,
//                       row forces and pair virial; once per MD step;
//   qeq_count_kernel,   `make_qeq_pair_fn.pair_fn` (:439-475): the QEq
//   qeq_fill_kernel     hessian, built once per QEq solve as a CSR list;
//   qeq_apply_kernel    that list applied to hs, ht and q (the Est pair sum),
//                       once per CG iteration.
// The plain PyTorch versions of the same functions are
// rxmd_tpu_torch/ops/pairsweep.py `nonbond_plain`, `qeq_build_plain` and
// `qeq_apply_plain`.
//
// Design.  The TPU kernel sweeps 128-slot target blocks over a shared
// window, padded slots included.  Here one warp owns one target (a filled
// slot; the engine's targets are the primary atoms in slot order, so
// neighbouring warps share cells in L1/L2) and walks the target's own
// window: per stencil column the z-cells within that column's reach of the
// target's z-cell (a host table, counted with rctap + skin), and in each
// cell only its filled slots (the cell counts of the slot binning), which
// in the order of the filled slots are one run per column.  At 8,064 atoms
// that is 1.38e7 filled-slot candidates a walk against the block sweep's
// 1.39e9 slot tests.  The lanes test 32 filled slots at a time; the
// pairs that pass every gate are compacted through a per-warp queue in
// shared memory and evaluated 32 at a time with every lane busy, in walk
// order.  Row ownership stays: each warp reduces its lanes' sums by
// shuffles and writes its target's row; no atomics.
//
// The hessian element depends only on positions and types, which a QEq
// solve holds fixed, so the CG iterations no longer recompute it: the build
// writes (owner index with an image flag, h) per pair, 8 bytes, in two
// passes (count, then fill at the counts' prefix sums), and the apply reads
// the list once per iteration with one warp per row and gathers hs, ht and
// q by owner index.
//
// What bounds them on the H100: the apply is bound by bytes (the list, 8
// bytes a pair); the build by bytes (the list it writes) and by the walk's
// slot tests; the nonbond kernel by arithmetic (two powf, an expf, a sqrtf
// and a cube root per pair) once the walk has culled the candidates.
// Cutoff gates use the distance summed with rounding at every step
// (dist2), as the plain versions sum it, so both keep the same pairs.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;          // warps (targets) per block
constexpr int kQueue = 64;         // queued slots per warp
constexpr unsigned kFull = 0xffffffffu;

struct WalkGeom {
  const float* planes;      // (K, nslots): x, y, z, type, then per kernel
  const int* tslot;         // (T,) target slots
  const int* coloffs;       // (ncols,) slot offset of each stencil column
  const int* zreach;        // (ncols,) z-cells of reach of each column
  const int* cell_start;    // (ncells + 1,) cell c holds filled slots
  const int* slots;         //   slots[cell_start[c] .. cell_start[c + 1])
  const float* table;       // (nso, nso, P) type-pair parameters
  const float* ctap;        // (8,) taper coefficients
  int T, ncols, nzc, cshift, nso, nslots;
  float rc2;                // pair gate (rctap^2)
};

__device__ __forceinline__ int type_index(float t, int nso) {
  int i = static_cast<int>(t);
  return i < 0 ? 0 : (i >= nso ? nso - 1 : i);
}

__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ void taper(const float* ct, float dr2, float dr1,
                                      float& tap, float& dtap) {
  const float dr3 = dr1 * dr2, dr4 = dr2 * dr2, dr5 = dr1 * dr4;
  const float dr6 = dr2 * dr4, dr7 = dr1 * dr6;
  tap = ct[7] * dr7 + ct[6] * dr6 + ct[5] * dr5 + ct[4] * dr4 + ct[0];
  dtap = 7.f * ct[7] * dr5 + 6.f * ct[6] * dr4 + 5.f * ct[5] * dr3 +
         4.f * ct[4] * dr2;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The block's copy of the type-pair table and taper coefficients; the
// per-warp queues follow them in shared memory.
__device__ __forceinline__ int* load_consts(const WalkGeom& g, int P,
                                            float* smem) {
  float* tbl = smem;
  float* ct = tbl + g.nso * g.nso * P;
  for (int i = threadIdx.x; i < g.nso * g.nso * P; i += blockDim.x)
    tbl[i] = g.table[i];
  if (threadIdx.x < 8) ct[threadIdx.x] = g.ctap[threadIdx.x];
  __syncthreads();
  return reinterpret_cast<int*>(ct + 8) + (threadIdx.x >> 5) * kQueue;
}

// Walks target slot `ts`: per stencil column, the z-cells within the
// column's reach of the target's z-cell, clamped into the column, and in
// each cell its filled slots.  Over the filled slots in slot order those
// cells are one run, cell_start[first cell] .. cell_start[last cell + 1],
// taken 32 slots per step, every lane loading its slot's position and type
// at once (the gates combine without short-circuit; past the run's end a
// lane reads the last slot again).  A slot that passes `accept` is queued
// in walk order; `take(slot, k)` gets the k-th accepted slot, 32 at a time
// with all lanes busy and the rest at the end.  Returns the number
// accepted.  Called by all 32 lanes of a warp.
template <class Accept, class Take>
__device__ __forceinline__ int walk(const WalkGeom& g, int ts, int lane,
                                    int* q, Accept accept, Take take) {
  const int zc = ts % g.nzc;
  const int nbase = ts - zc;
  const int tz = zc >> g.cshift;
  const int zmax = (g.nzc >> g.cshift) - 1;
  const unsigned below = (1u << lane) - 1u;
  int qn = 0, done = 0;
  for (int s = 0; s < g.ncols; ++s) {
    const int cb = (nbase + g.coloffs[s]) >> g.cshift;   // column's cell 0
    const int r = g.zreach[s];
    const int lo = g.cell_start[cb + max(tz - r, 0)];
    const int hi = g.cell_start[cb + min(tz + r, zmax) + 1];
    for (int b = lo; b < hi; b += 32) {
      const int slot = g.slots[min(b + lane, hi - 1)];
      const bool ok = (b + lane < hi) & accept(slot);
      const unsigned m = __ballot_sync(kFull, ok);
      if (ok) q[qn + __popc(m & below)] = slot;
      qn += __popc(m);
      if (qn >= 32) {
        __syncwarp();
        take(q[lane], done + lane);
        done += 32;
        qn -= 32;
        __syncwarp();
        if (lane < qn) q[lane] = q[lane + 32];
        __syncwarp();
      }
    }
  }
  __syncwarp();
  if (lane < qn) take(q[lane], done + lane);
  return done + qn;
}

// The nonbond body (rxmd_tpu/ops/pairsweep.py:355-423) over the walk, once
// per MD step.  Bound by arithmetic (~100 operations a pair, two powf, an
// expf, two sqrtf and a cube root); the queue keeps all 32 lanes on pairs
// that pass every gate, and 11 row sums per lane end in shuffles.
// planes: 0:x 1:y 2:z 3:type 4:gid 5:q
// rows:   evdw eclmb fx fy fz w_xx w_yy w_zz w_yz w_zx w_xy
__global__ void __launch_bounds__(kWarps * 32) nonbond_kernel(
    WalkGeom g, const int* __restrict__ trow, float* __restrict__ out,
    int nrows, float pvdW1h, float pvdW1inv, float cclmb) {
  constexpr int P = 6;
  extern __shared__ float smem[];
  int* q = load_consts(g, P, smem);
  const float* tbl = smem;
  const float* ct = tbl + g.nso * g.nso * P;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= g.T) return;
  const size_t ns = g.nslots;
  const float* __restrict__ X = g.planes;
  const float *Y = X + ns, *Z = X + 2 * ns, *TY = X + 3 * ns;
  const float *GID = X + 4 * ns, *QS = X + 5 * ns;
  const int ts = g.tslot[i];
  const float tx = X[ts], ty = Y[ts], tz = Z[ts], tgid = GID[ts], tq = QS[ts];
  const float* trow_tbl = tbl + type_index(TY[ts], g.nso) * g.nso * P;
  float acc[11];
#pragma unroll
  for (int o = 0; o < 11; ++o) acc[o] = 0.f;

  walk(
      g, ts, lane, q,
      [&](int j) {
        const float dr2 = dist2(tx - X[j], ty - Y[j], tz - Z[j]);
        const bool typed = trow_tbl[type_index(TY[j], g.nso) * P] > 0.5f;
        return (dr2 <= g.rc2) & (dr2 > 1e-6f) & (tgid != GID[j]) & typed;
      },
      [&](int j, int) {
        const float dx = tx - X[j], dy = ty - Y[j], dz = tz - Z[j];
        const float dr2 = dist2(dx, dy, dz);
        const float* pr = trow_tbl + type_index(TY[j], g.nso) * P;
        const float dr1 = sqrtf(dr2);
        float tap, dtap;
        taper(ct, dr2, dr1, tap, dtap);
        const float rij_vd1 = powf(dr2, pvdW1h);
        const float gw = rij_vd1 + pr[1];
        const float fn13 = powf(gw, pvdW1inv);
        const float exp1 = expf(pr[2] * (1.f - fn13 * pr[3]));
        const float exp2 = sqrtf(exp1);
        const float dr3gam = powf(dr1 * dr2 + pr[5], -1.f / 3.f);
        const float qq = tq * QS[j];
        const float evdw = tap * pr[4] * (exp1 - 2.f * exp2);
        const float eclmb = tap * cclmb * dr3gam * qq;
        // (dE/dr)/r, ref: pot.F90:736-761
        const float dfn13 = fn13 / gw * (rij_vd1 / dr2);
        const float devdw =
            pr[4] * (dtap * (exp1 - 2.f * exp2) -
                     tap * (pr[2] * pr[3]) * (exp1 - exp2) * dfn13);
        const float declmb = cclmb * dr3gam *
                             (dtap - dr3gam * dr3gam * dr3gam * tap * dr1) *
                             qq;
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
      });
#pragma unroll
  for (int o = 0; o < 11; ++o) acc[o] = warp_sum(acc[o]);
  if (lane == 0) {
    const int row = trow[i];
#pragma unroll
    for (int o = 0; o < 11; ++o)
      out[static_cast<size_t>(o) * nrows + row] = acc[o];
  }
}

// planes: 0:x 1:y 2:z 3:type 4:is_primary.  The QEq pair gate, the same in
// both passes of the build.
struct QeqGate {
  const float *X, *Y, *Z, *TY;
  const float* trow_tbl;
  float tx, ty, tz, rc2;
  int nso;
  __device__ __forceinline__ bool operator()(int j) const {
    const float dr2 = dist2(tx - X[j], ty - Y[j], tz - Z[j]);
    const bool typed = trow_tbl[type_index(TY[j], nso) * 2] > 0.5f;
    return (dr2 <= rc2) & (dr2 > 1e-6f) & typed;
  }
};

__device__ __forceinline__ QeqGate qeq_gate(const WalkGeom& g,
                                            const float* tbl, int ts) {
  const size_t ns = g.nslots;
  QeqGate q;
  q.X = g.planes;
  q.Y = q.X + ns;
  q.Z = q.X + 2 * ns;
  q.TY = q.X + 3 * ns;
  q.trow_tbl = tbl + type_index(q.TY[ts], g.nso) * g.nso * 2;
  q.tx = q.X[ts];
  q.ty = q.Y[ts];
  q.tz = q.Z[ts];
  q.rc2 = g.rc2;
  q.nso = g.nso;
  return q;
}

// The QEq body (rxmd_tpu/ops/pairsweep.py:439-475), split: its hessian is
// built once per QEq solve by the two passes below and applied once per CG
// iteration by qeq_apply_kernel.  The build is bound by the list it writes
// (8 bytes a pair) and by the walk's slot tests.  It counts first and fills
// at the prefix sums (a device cumsum between the passes), into a list of a
// capacity the host fixed at the rebuild: no host read between the passes,
// so a CUDA graph can hold the build.
// First pass of the build: the number of entries of each target.
__global__ void __launch_bounds__(kWarps * 32) qeq_count_kernel(
    WalkGeom g, int* __restrict__ cnt) {
  extern __shared__ float smem[];
  int* q = load_consts(g, 2, smem);
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= g.T) return;
  const int ts = g.tslot[i];
  const int n = walk(g, ts, lane, q, qeq_gate(g, smem, ts), [](int, int) {});
  if (lane == 0) cnt[i] = n;
}

// Second pass: entries rowptr[i]..rowptr[i+1] of target i, in walk order:
// src = the source's owner (~owner for an image), h = the hessian element;
// entries at or past `cap` are not written, and *need = rowptr[T], the
// entries the walk found, tells the host whether the capacity sufficed.
__global__ void __launch_bounds__(kWarps * 32) qeq_fill_kernel(
    WalkGeom g, const int* __restrict__ own, const int* __restrict__ rowptr,
    int* __restrict__ src, float* __restrict__ h, int cap,
    int* __restrict__ need, float cclmb_qeq) {
  extern __shared__ float smem[];
  int* q = load_consts(g, 2, smem);
  const float* ct = smem + g.nso * g.nso * 2;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i == 0 && lane == 0) *need = rowptr[g.T];
  if (i >= g.T) return;
  const int ts = g.tslot[i];
  const QeqGate gate = qeq_gate(g, smem, ts);
  const float* PRIM = g.planes + 4 * static_cast<size_t>(g.nslots);
  const int e0 = rowptr[i], e1 = min(rowptr[i + 1], cap);
  walk(g, ts, lane, q, gate, [&](int j, int k) {
    const int e = e0 + k;
    if (e >= e1) return;
    const float dr2 = dist2(gate.tx - gate.X[j], gate.ty - gate.Y[j],
                            gate.tz - gate.Z[j]);
    const float dr1 = sqrtf(dr2);
    float tap, dtap;
    taper(ct, dr2, dr1, tap, dtap);
    const float gam = gate.trow_tbl[type_index(gate.TY[j], g.nso) * 2 + 1];
    h[e] = cclmb_qeq * tap * powf(dr1 * dr2 + gam, -1.f / 3.f);
    const int o = own[j];
    src[e] = PRIM[j] > 0.5f ? o : ~o;
  });
}

// One warp per row: sum h*hs[o], h*ht[o] and h*w*q[o] over the row's
// entries (o = src or ~src, w = 1 for a primary source, 0.5 for an image).
// Bound by bytes: the list, read once per CG iteration in coalesced 32-entry
// strides (the gathered (n,) vectors sit in L1/L2); it can stay in the 50 MB
// L2 between iterations.  hs, ht and q are read with their element strides,
// so the CG's (n, 2) state goes in as two column views, uncopied.  Entries at
// or past `cap` (an overflowed list, which the host raises on) are skipped.
__global__ void __launch_bounds__(kWarps * 32) qeq_apply_kernel(
    const int* __restrict__ rowptr, const int* __restrict__ src,
    const float* __restrict__ h, const int* __restrict__ trow,
    const float* __restrict__ hs, const float* __restrict__ ht,
    const float* __restrict__ qv, long long shs, long long sht, long long sq,
    float* __restrict__ out, int T, int nrows, int cap) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= T) return;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  const int e1 = min(rowptr[i + 1], cap);
  for (int e = rowptr[i] + lane; e < e1; e += 32) {
    const int c = src[e];
    const float hv = h[e];
    const long long o = c >= 0 ? c : ~c;
    const float qo = qv[o * sq];
    a0 += hv * hs[o * shs];
    a1 += hv * ht[o * sht];
    a2 += hv * (c >= 0 ? qo : 0.5f * qo);
  }
  a0 = warp_sum(a0);
  a1 = warp_sum(a1);
  a2 = warp_sum(a2);
  if (lane == 0) {
    const int row = trow[i];
    out[row] = a0;
    out[nrows + row] = a1;
    out[2 * static_cast<size_t>(nrows) + row] = a2;
  }
}

WalkGeom make_geom(const float* planes, const int* tslot, const int* coloffs,
                   const int* zreach, const int* cell_start, const int* slots,
                   const float* table, const float* ctap, int T, int ncols,
                   int nzc, int cshift, int nso, int nslots, float rc2) {
  WalkGeom g;
  g.planes = planes; g.tslot = tslot; g.coloffs = coloffs;
  g.zreach = zreach; g.cell_start = cell_start; g.slots = slots;
  g.table = table;
  g.ctap = ctap; g.T = T; g.ncols = ncols; g.nzc = nzc; g.cshift = cshift;
  g.nso = nso; g.nslots = nslots; g.rc2 = rc2;
  return g;
}

size_t walk_smem(int nso, int P) {
  return sizeof(float) * (nso * nso * P + 8) + sizeof(int) * kWarps * kQueue;
}

int blocks_of(int T) { return (T + kWarps - 1) / kWarps; }

}  // namespace

#define WALK_ARGS                                                          \
  const float *planes, const int *tslot, const int *coloffs,               \
      const int *zreach, const int *cell_start, const int *slots,          \
      const float *table, const float *ctap, int T, int ncols, int nzc,    \
      int cshift, int nso, int nslots, float rc2
#define WALK_GEOM                                                          \
  make_geom(planes, tslot, coloffs, zreach, cell_start, slots, table,      \
            ctap, T, ncols, nzc, cshift, nso, nslots, rc2)

// Each entry launches on `stream` and returns the cudaError_t of the
// launch (0 on success); it does not synchronise.  T must be positive.
extern "C" int pairsweep_nonbond(WALK_ARGS, const int* trow, float* out,
                                 int nrows, float pvdW1h, float pvdW1inv,
                                 float cclmb, void* stream) {
  nonbond_kernel<<<blocks_of(T), kWarps * 32, walk_smem(nso, 6),
                   static_cast<cudaStream_t>(stream)>>>(
      WALK_GEOM, trow, out, nrows, pvdW1h, pvdW1inv, cclmb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pairsweep_qeq_count(WALK_ARGS, int* cnt, void* stream) {
  qeq_count_kernel<<<blocks_of(T), kWarps * 32, walk_smem(nso, 2),
                     static_cast<cudaStream_t>(stream)>>>(WALK_GEOM, cnt);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pairsweep_qeq_fill(WALK_ARGS, const int* own,
                                  const int* rowptr, int* src, float* h,
                                  int cap, int* need, float cclmb_qeq,
                                  void* stream) {
  qeq_fill_kernel<<<blocks_of(T), kWarps * 32, walk_smem(nso, 2),
                    static_cast<cudaStream_t>(stream)>>>(
      WALK_GEOM, own, rowptr, src, h, cap, need, cclmb_qeq);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pairsweep_qeq_apply(const int* rowptr, const int* src,
                                   const float* h, const int* trow,
                                   const float* hs, const float* ht,
                                   const float* q, long long shs,
                                   long long sht, long long sq, float* out,
                                   int T, int nrows, int cap, void* stream) {
  qeq_apply_kernel<<<blocks_of(T), kWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      rowptr, src, h, trow, hs, ht, q, shs, sht, sq, out, T, nrows, cap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pairsweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
