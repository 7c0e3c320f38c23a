// Cell-walk nonbonded pair kernels for Hopper (sm_90a), bound with ctypes.
//
// Replace the TPU kernel rxmd_tpu/ops/pairsweep.py `_sweep` (:231-295, the
// one pl.pallas_call at :289) with its two pair bodies:
//   nonbond_kernel      `make_nonbond_pair_fn.pair_fn` (:355-423): vdW +
//                       shielded Coulomb with the 7th-order taper, energies,
//                       row forces and pair virial; once per MD step;
//   qeq_build_kernel    `make_qeq_pair_fn.pair_fn` (:439-475): the QEq
//                       hessian, built once per QEq solve as a list;
//   qeq_apply_kernel    that list applied to the CG's (n, 2) state and to q
//                       (the Est pair sum), once per CG matvec.
// The plain PyTorch versions of the same functions are
// rxmd_tpu_torch/ops/pairsweep.py `nonbond_plain`, `qeq_build_plain` and
// `qeq_apply_plain`.
//
// The walk.  The TPU kernel sweeps 128-slot target blocks over a shared
// window, padded slots included.  Here a target (a filled slot; the
// engine's targets are the primary atoms in slot order) visits, per
// stencil column, the z-cells within that column's reach of its own z-cell
// (a host table, counted with rctap + skin), and in each cell only its
// filled slots (the cell counts of the slot binning), which in the order
// of the filled slots are one run per column.  At 8,064 atoms that is
// 1.38e7 filled-slot candidates a walk against the block sweep's 1.39e9
// slot tests; a quarter of them pass the gates.  Cutoff gates use the
// distance summed with rounding at every step (dist2), as the plain
// versions sum it, so both keep the same pairs.
//
// nonbond_kernel: bound by arithmetic (two powf, an expf, a sqrtf and a
// cube root per pair).  One warp owns one target and walks its window,
// 32 filled slots at a time; the pairs that pass every gate are compacted
// through a per-warp queue in shared memory and evaluated 32 at a time
// with every lane busy, in walk order; shuffles reduce the row, no atomics.
//
// The QEq hessian element depends only on positions and types, which a
// solve holds fixed, so the CG's matvecs read it from a list built once
// per solve: per entry one 8-byte record (the source's owner, ~owner for
// an image; the bits of h).  Target i's entries start at qstart[i], the
// prefix sum of the walk candidates of the targets before it, which
// depends on the slot map alone (made with it, at the rebuild), so one
// walk places every entry and writes each target's count: no count pass.
// The layout asks qstart[T] records of the list's capacity; entries at or
// past the capacity are not written, and the host raises on such a list.
//
// qeq_build_kernel: bound by bytes (the list it writes) once the walk's
// loads are its own.  The old per-target walk loaded slots[] and then x, y,
// z, type through it for each of the 1.38e7 candidates (~275 MB of L1/L2
// traffic for a 28 MB list), though the targets of a z-run of cells in one
// column share almost all of their windows.  Here a block takes up to 32
// consecutive targets of one column (a table made with the slot map, so a
// block never pays for a second column's staging: with fixed runs of 32,
// the edge blocks spanned up to 6 columns and set the kernel's time; the
// largest blocks start first), in groups of at most kBuildZ z-cells; per group it stages the union of its
// targets' windows once into shared
// memory, column after column, as packed float4 (x, y, z, type) records and
// owner codes (in chunks of kStage slots where the union outgrows one), and
// each warp tests its targets against the staged slots in walk order, the
// passing pairs queued and evaluated 32 at a time as in the nonbond kernel.
//
// qeq_apply_kernel: bound by bytes (the list, 8 bytes an entry, read once
// per matvec; it can stay in the 50 MB L2 between iterations).  Each lane
// loads 2 x kApplyU records with 16-byte loads before its first gather,
// the (hs, ht) pair of a source is one 8-byte gather from the (n, 2)
// state, and q's gather is left out when the caller passes none (the CG's
// gradient).  A row takes kApplyLanes = 16 lanes: 8 take the same time, 32
// a quarter more (8,064 rows of 32 lanes are more warps than the card
// holds at once; scripts/qeq_apply_forms.py).  A row's sum is
// deterministic: each lane sums its entries in order, then a fixed shuffle
// tree.

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

// The QEq body (rxmd_tpu/ops/pairsweep.py:439-475), split: its hessian is
// built once per QEq solve by qeq_build_kernel and applied once per CG
// matvec by qeq_apply_kernel.
constexpr int kBuildWarps = 16;    // warps per build block
constexpr int kBuildTargets = 32;  // targets per build block, one a lane
constexpr int kBuildZ = 16;        // z-cells a group of targets spans at most
constexpr int kStage = 4096;       // filled slots staged at a time
constexpr int kLoads = 4;          // staged slots a thread loads at once

// The build block's shared memory, in order: the staged slots (float4 x,
// y, z, type; int owner codes), the type-pair table and taper, per stencil
// column its first cell, lowest z-cell, first filled slot, reach and
// offset in the staged order (ncols + 1), the chunks' first columns
// (ncols + 2), per column the staged offset of each cell's first slot
// (vstride a column), the targets' counts and the warps' queues.
size_t build_smem(int nso, int ncols, int vstride) {
  return 20 * static_cast<size_t>(kStage) +
         sizeof(float) * (nso * nso * 2 + 8) +
         sizeof(int) * (4 * ncols + (ncols + 1) + (ncols + 2) +
                        ncols * vstride + kBuildTargets +
                        kBuildWarps * kQueue + 1);
}

// planes: 0:x 1:y 2:z 3:type 4:is_primary; own: (nslots,) owner of each
// slot.  Block b takes targets qblock[2b] .. qblock[2b + 1] (at most
// kBuildTargets, of one column; past the walk's T, none).  Target i (of
// the walk's T) writes its entries in walk order to rec[qstart[i] + k]
// (those below `cap`) and its count to count[i].  vstride = kBuildZ + 2 *
// (the grid's zreach) + 1.
__global__ void __launch_bounds__(kBuildWarps * 32, 2) qeq_build_kernel(
    WalkGeom g, const int* __restrict__ own, const int* __restrict__ qstart,
    const int* __restrict__ qblock, int2* __restrict__ rec,
    int* __restrict__ count, int cap, int vstride, float cclmb_qeq) {
  extern __shared__ float4 smem4[];
  float4* tile = smem4;
  int* code = reinterpret_cast<int*>(tile + kStage);
  float* tbl = reinterpret_cast<float*>(code + kStage);
  float* ct = tbl + g.nso * g.nso * 2;
  int* col_cb = reinterpret_cast<int*>(ct + 8);
  int* col_zlo = col_cb + g.ncols;
  int* col_ulo = col_zlo + g.ncols;
  int* col_r = col_ulo + g.ncols;
  int* col_off = col_r + g.ncols;
  int* chunk_col = col_off + g.ncols + 1;
  int* V = chunk_col + g.ncols + 2;
  int* tcnt = V + g.ncols * vstride;
  int* queue = tcnt + kBuildTargets;
  int* nchunk = queue + kBuildWarps * kQueue;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k = tid; k < g.nso * g.nso * 2; k += blockDim.x) tbl[k] = g.table[k];
  if (tid < 8) ct[tid] = g.ctap[tid];
  for (int s = tid; s < g.ncols; s += blockDim.x) col_r[s] = g.zreach[s];

  const size_t ns = g.nslots;
  const float* __restrict__ X = g.planes;
  const float *Y = X + ns, *Z = X + 2 * ns, *TY = X + 3 * ns;
  const float* PRIM = X + 4 * ns;
  const int zmax = (g.nzc >> g.cshift) - 1;
  const int ccap = 1 << g.cshift;
  // a column's staged run is at most (kBuildZ + 2 zreach) cells; the chunks
  // start at multiples of W, so each holds at most W - 1 + that < kStage
  const int W = kStage - (vstride - 1) * ccap;
  const unsigned below = (1u << lane) - 1u;
  int* q = queue + warp * kQueue;

  // every warp holds the block's targets, one a lane
  const int i0 = min(qblock[2 * blockIdx.x], g.T);
  const int nt =
      min(kBuildTargets, min(qblock[2 * blockIdx.x + 1], g.T) - i0);
  int col = 0, tzc = 0, qs = 0;
  float4 tp = make_float4(0.f, 0.f, 0.f, 0.f);
  if (lane < nt) {
    const int ts = g.tslot[i0 + lane];
    col = ts / g.nzc;
    tzc = (ts - col * g.nzc) >> g.cshift;
    tp = make_float4(X[ts], Y[ts], Z[ts], TY[ts]);
    qs = qstart[i0 + lane];
  }

  for (int gs = 0; gs < nt;) {
    // the group: targets gs.. of one column within kBuildZ z-cells of the
    // first one's
    const int gcol = __shfl_sync(kFull, col, gs);
    const int gz0 = __shfl_sync(kFull, tzc, gs);
    const unsigned brk =
        __ballot_sync(kFull, lane >= nt || col != gcol || tzc < gz0 ||
                                 tzc - gz0 >= kBuildZ) &
        ~((2u << gs) - 1u);
    const int ge = brk ? __ffs(brk) - 1 : nt;
    const int gz1 =
        __reduce_max_sync(kFull, lane >= gs && lane < ge ? tzc : gz0);
    __syncthreads();   // the previous group is done with the tables
    for (int s = tid; s < g.ncols; s += blockDim.x) {
      const int cb = (gcol * g.nzc + g.coloffs[s]) >> g.cshift;
      const int zlo = max(gz0 - col_r[s], 0);
      const int zhi = min(gz1 + col_r[s], zmax);
      col_cb[s] = cb;
      col_zlo[s] = zlo;
      col_ulo[s] = g.cell_start[cb + zlo];
      col_off[s] = g.cell_start[cb + zhi + 1] - col_ulo[s];   // length
    }
    if (tid < kBuildTargets) tcnt[tid] = 0;
    __syncthreads();
    if (warp == 0) {   // exclusive prefix sums of the lengths
      int run = 0;
      for (int b = 0; b < g.ncols; b += 32) {
        const int s = b + lane;
        const int len = s < g.ncols ? col_off[s] : 0;
        int inc = len;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(kFull, inc, o);
          if (lane >= o) inc += v;
        }
        if (s < g.ncols) col_off[s] = run + inc - len;
        run += __shfl_sync(kFull, inc, 31);
      }
      if (lane == 0) col_off[g.ncols] = run;
    }
    __syncthreads();
    // chunk k: the columns whose staged offsets lie in [k W, (k + 1) W)
    for (int s = tid; s < g.ncols; s += blockDim.x) {
      const int k = col_off[s] / W;
      if (s == 0 || col_off[s - 1] / W != k) chunk_col[k] = s;
    }
    if (tid == 0) {
      const int n = col_off[g.ncols - 1] / W + 1;
      chunk_col[n] = g.ncols;
      *nchunk = n;
    }
    // per column and z-cell of its run, the staged offset of the cell's
    // first filled slot (and of the slot past the run's last cell); the
    // loads of kLoads entries in flight at once
    for (int x0 = tid; x0 < g.ncols * vstride;
         x0 += kLoads * blockDim.x) {
      int cs[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int x = x0 + u * blockDim.x;
        const int s = x / vstride, z = x - s * vstride;
        cs[u] = x < g.ncols * vstride &&
                        col_zlo[s] + z <= min(gz1 + col_r[s], zmax) + 1
                    ? g.cell_start[col_cb[s] + col_zlo[s] + z]
                    : -1;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int x = x0 + u * blockDim.x;
        const int s = x / vstride;
        if (cs[u] >= 0) V[x] = cs[u] - col_ulo[s] + col_off[s];
      }
    }
    __syncthreads();

    const int nch = *nchunk;
    for (int k = 0; k < nch; ++k) {
      const int s0 = chunk_col[k], s1 = chunk_col[k + 1];
      const int vb = col_off[s0], m = col_off[s1] - vb;
      // staged slot j: kLoads of them a thread at once, their slot
      // indices first, then their planes and owners
      for (int j0 = tid; j0 < m; j0 += kLoads * blockDim.x) {
        int slot[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int v = vb + j0 + u * blockDim.x;
          int lo = s0, hi = s1 - 1;   // the last column starting at or
          while (lo < hi) {           // before v
            const int mid = (lo + hi + 1) >> 1;
            if (col_off[mid] <= v) lo = mid; else hi = mid - 1;
          }
          slot[u] = v < vb + m ? g.slots[col_ulo[lo] + v - col_off[lo]] : -1;
        }
        float4 p[kLoads];
        int o[kLoads];
        float pr[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int sl = max(slot[u], 0);
          p[u] = make_float4(X[sl], Y[sl], Z[sl], TY[sl]);
          o[u] = own[sl];
          pr[u] = PRIM[sl];
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int j = j0 + u * blockDim.x;
          if (slot[u] >= 0) {
            tile[j] = p[u];
            code[j] = pr[u] > 0.5f ? o[u] : ~o[u];
          }
        }
      }
      __syncthreads();
      for (int t = gs + warp; t < ge; t += kBuildWarps) {
        const int tz = __shfl_sync(kFull, tzc, t);
        const float tx = __shfl_sync(kFull, tp.x, t);
        const float ty = __shfl_sync(kFull, tp.y, t);
        const float tzp = __shfl_sync(kFull, tp.z, t);
        const float tty = __shfl_sync(kFull, tp.w, t);
        const int e0 = __shfl_sync(kFull, qs, t) + tcnt[t];
        const float* trow_tbl = tbl + type_index(tty, g.nso) * g.nso * 2;
        // the k-th passing slot of this chunk: its record
        auto take = [&](int j, int kk) {
          const int e = e0 + kk;
          if (e >= cap) return;
          const float4 p = tile[j];
          const float dr2 = dist2(tx - p.x, ty - p.y, tzp - p.z);
          const float dr1 = sqrtf(dr2);
          float tap, dtap;
          taper(ct, dr2, dr1, tap, dtap);
          const float gam = trow_tbl[type_index(p.w, g.nso) * 2 + 1];
          const float h = cclmb_qeq * tap * powf(dr1 * dr2 + gam, -1.f / 3.f);
          rec[e] = make_int2(code[j], __float_as_int(h));
        };
        int qn = 0, done = 0;
        // the target's staged run [a, b) in each column: 32 columns at a
        // time, one a lane, then column by column in walk order
        for (int c0 = s0; c0 < s1; c0 += 32) {
          int ra = 0, rb = 0;
          if (c0 + lane < s1) {
            const int s = c0 + lane;
            const int r = col_r[s], zlo = col_zlo[s];
            const int* Vs = V + s * vstride;
            ra = Vs[max(tz - r, 0) - zlo] - vb;
            rb = Vs[min(tz + r, zmax) + 1 - zlo] - vb;
          }
          for (int c = 0; c < min(32, s1 - c0); ++c) {
            const int a = __shfl_sync(kFull, ra, c);
            const int b = __shfl_sync(kFull, rb, c);
            for (int j0 = a; j0 < b; j0 += 32) {
              const int j = j0 + lane;
              bool ok = false;
              if (j < b) {
                const float4 p = tile[j];
                const float dr2 = dist2(tx - p.x, ty - p.y, tzp - p.z);
                ok = (dr2 <= g.rc2) & (dr2 > 1e-6f) &
                     (trow_tbl[type_index(p.w, g.nso) * 2] > 0.5f);
              }
              const unsigned msk = __ballot_sync(kFull, ok);
              if (ok) q[qn + __popc(msk & below)] = j;
              qn += __popc(msk);
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
        }
        __syncwarp();
        if (lane < qn) take(q[lane], done + lane);
        __syncwarp();
        if (lane == 0) {
          tcnt[t] += done + qn;
          if (k == nch - 1) count[i0 + t] = tcnt[t];
        }
      }
      __syncthreads();   // before the next chunk is staged
    }
    gs = ge;
  }
}

// Row i of the list: entries start[i] .. start[i] + count[i] (those below
// `cap`), record (c, bits of h) with source owner o = c or ~c; sums h*x[o]
// (the two columns of the (n, 2) state x) and, with kQ, h*w*q[o] (w = 1
// for a primary source, 0.5 for an image).  L lanes a row; each lane takes
// the aligned record pairs 2*sub, 2*sub + 2L, ... in turn, kApplyU of them
// loaded before the first gather.
constexpr int kApplyThreads = 128;
constexpr int kApplyLanes = 16;
constexpr int kApplyU = 4;

template <int L, bool kQ>
__global__ void __launch_bounds__(kApplyThreads) qeq_apply_kernel(
    const int* __restrict__ start, const int* __restrict__ count,
    const int2* __restrict__ rec, const int* __restrict__ trow,
    const float2* __restrict__ x, const float* __restrict__ qv,
    float* __restrict__ out, int T, int nrows, int cap) {
  const int sub = threadIdx.x & (L - 1);
  const int i = (blockIdx.x * kApplyThreads + threadIdx.x) / L;
  int e0 = 0, e1 = 0;
  if (i < T) {
    e0 = start[i];
    e1 = min(e0 + count[i], cap);
  }
  const int4* rec4 = reinterpret_cast<const int4*>(rec);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int p = (e0 & ~1) + 2 * sub; p < e1; p += 2 * L * kApplyU) {
    int4 r[kApplyU];
#pragma unroll
    for (int u = 0; u < kApplyU; ++u) {
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
    float h[2 * kApplyU], w[2 * kApplyU], qo[2 * kApplyU];
    float2 xo[2 * kApplyU];
#pragma unroll
    for (int u = 0; u < kApplyU; ++u) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int pe = p + 2 * L * u + k;
        const bool ok = pe >= e0 && pe < e1;
        const int c = k ? r[u].z : r[u].x;
        const int o = c >= 0 ? c : ~c;
        const int m = 2 * u + k;
        h[m] = ok ? __int_as_float(k ? r[u].w : r[u].y) : 0.f;
        w[m] = c >= 0 ? 1.f : 0.5f;
        xo[m] = ok ? __ldg(x + o) : make_float2(0.f, 0.f);
        qo[m] = kQ && ok ? __ldg(qv + o) : 0.f;
      }
    }
#pragma unroll
    for (int m = 0; m < 2 * kApplyU; ++m) {
      a0 += h[m] * xo[m].x;
      a1 += h[m] * xo[m].y;
      if (kQ) a2 += h[m] * (w[m] * qo[m]);
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    a0 += __shfl_xor_sync(kFull, a0, off);
    a1 += __shfl_xor_sync(kFull, a1, off);
    a2 += __shfl_xor_sync(kFull, a2, off);
  }
  if (sub == 0 && i < T) {
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

// The build block's shared memory for the grid (0 if kStage cannot hold
// twice a column's longest run), granted to the kernel with the SM's whole
// carveout as shared memory, so that two blocks fit an SM.
size_t build_grant(int nso, int ncols, int zreach_max, int cshift,
                   cudaError_t* err) {
  const int vstride = kBuildZ + 2 * zreach_max + 1;
  *err = cudaSuccess;
  if (kStage <= 2 * (vstride - 1) * (1 << cshift)) {
    *err = cudaErrorInvalidValue;
    return 0;
  }
  const size_t smem = build_smem(nso, ncols, vstride);
  static size_t granted = 0;
  if (smem > granted) {
    *err = cudaFuncSetAttribute(qeq_build_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
    if (*err == cudaSuccess)
      *err = cudaFuncSetAttribute(
          qeq_build_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (*err != cudaSuccess) return 0;
    granted = smem;
  }
  return smem;
}

// The QEq build: one launch; vstride from the grid's largest reach.
extern "C" int pairsweep_qeq_build(WALK_ARGS, int zreach_max, const int* own,
                                   const int* qstart, const int* qblock,
                                   int nblocks, int targets, int* rec,
                                   int* count, int cap, float cclmb_qeq,
                                   void* stream) {
  if (targets != kBuildTargets) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  const size_t smem = build_grant(nso, ncols, zreach_max, cshift, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vstride = kBuildZ + 2 * zreach_max + 1;
  qeq_build_kernel<<<nblocks, kBuildWarps * 32, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      WALK_GEOM, own, qstart, qblock, reinterpret_cast<int2*>(rec), count,
      cap, vstride, cclmb_qeq);
  return static_cast<int>(cudaGetLastError());
}

// The build's resident blocks an SM, its threads a block and shared
// memory a block, for the grid.
extern "C" int pairsweep_qeq_build_occupancy(int nso, int ncols,
                                             int zreach_max, int cshift,
                                             int* blocks, int* threads,
                                             int* smem_bytes) {
  cudaError_t err;
  const size_t smem = build_grant(nso, ncols, zreach_max, cshift, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  *threads = kBuildWarps * 32;
  *smem_bytes = static_cast<int>(smem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, qeq_build_kernel, kBuildWarps * 32, smem));
}

// The QEq apply; q may be null (no Est row: it is written as 0).
extern "C" int pairsweep_qeq_apply(const int* start, const int* count,
                                   const int* rec, const int* trow,
                                   const float* x, const float* q,
                                   float* out, int T, int nrows, int cap,
                                   void* stream) {
  const int2* r = reinterpret_cast<const int2*>(rec);
  const float2* x2 = reinterpret_cast<const float2*>(x);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = static_cast<int>(
      (static_cast<long long>(T) * kApplyLanes + kApplyThreads - 1) /
      kApplyThreads);
  if (q != nullptr)
    qeq_apply_kernel<kApplyLanes, true><<<blocks, kApplyThreads, 0, st>>>(
        start, count, r, trow, x2, q, out, T, nrows, cap);
  else
    qeq_apply_kernel<kApplyLanes, false><<<blocks, kApplyThreads, 0, st>>>(
        start, count, r, trow, x2, q, out, T, nrows, cap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pairsweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
