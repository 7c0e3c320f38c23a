// The torsion and 4-body conjugation terms of ReaxFF for Hopper (sm_90a),
// bound with ctypes.
//
// Replaces no TPU kernel: rxmd_tpu evaluates the uncached torsions
// (rxmd_tpu/reax.py `e_4body`) as XLA ops over a dense (center, a, c, e)
// grid of candidate bonds, compacted into a flat list, and takes their
// gradients with jax.grad.  The port did the same with torch.autograd
// (rxmd_tpu_torch/reax.py `_torsion_mask_rows`, `build_torsion_list`), and
// on an H100 that grid set the term's cost: ks^3 cells a center (ks ~ 16),
// ~264 M at 64,512 atoms, ten boolean intermediates, an int64 cumsum and
// two scatters over them, then ~60 elementwise ops and three gathers over
// the list and autograd's index_add backward; 26.9 ms of a 99.8-ms MD step
// at 64,512 atoms, 4.0 of 17.0 at 8,064.
//
// torsion_kernel computes in one pass over each center's bonded row what
// that list's forward and backward gave (ref: pot.F90:1012-1219): E_tors
// and E_conj and, for each of them, its gradient with respect to BO0, the
// pi bond order, the bond vectors drb and delta.  rxmd_tpu_torch/ops/
// torsion.py wraps it in a torch.autograd.Function whose backward scales
// the saved gradients by each energy's gradient; they flow on through the
// bond order's autograd graph (the strain virial through drb).  The plain
// PyTorch version of the same function is `torsion_plain` there.  cos 2w
// and cos 3w are 2c^2 - 1 and 4c^3 - 3c of the clipped cos w (the plain
// version takes cos(2 arccos c) and cos(3 arccos c): the same function).
//
// Bound: bytes.  The inputs, BO0, the pi BO, drb (N x kb x 5 values), the
// ext indices and masks of the bonded rows, are read once a center row and
// again as owner(k)'s row from L2 (~30 MB at 64,512 atoms, kb 24, float32:
// L2 holds it); the gradients, 2 x N x kb x 5 values, are zeroed by the
// wrapper and added to in place.  The arithmetic, ~420 operations a
// torsion for ~12 torsions an atom, is a few microseconds of the card's
// 67 TFLOP/s at full lanes.  What sets the pace is the chain of dependent
// loads (slot, ext index, owner, type, the torsion type) and how few lanes
// a gate leaves live: a first form that evaluated each central bond's
// (a, e) pairs in place, 4-5 live lanes of 32 a pass with IEEE division,
// sqrt and exp, took 281 us at 8,064 atoms on an H100, 48 us of it
// without the arithmetic.  So the warp gates first and queues the
// torsions that pass, from all of a center's central bonds, in shared
// memory, and evaluates them 32 at a time on full lanes; in float32 the
// divisions, square roots and exponentials are the card's fast forms
// (__fdividef, rsqrtf, __expf: a few ulp), and each bond's length and unit
// vector are formed once, when its row is staged.
//
// Layout: one warp per center row j.  The warp compacts j's candidate
// slots (live, BO0 > CUTOF2_ESUB) with a ballot into shared memory: slot,
// BO0, pi BO, unit vector and length of drb, owner row, type, ext index
// and ext key.  For each candidate c whose owner k has gid(j) < gid(k) it
// compacts owner(k)'s candidates e the same way, keeping those that pass
// the gates of (c, e) alone (BO0_c * BO0_e > CUTOF2_ESUB, key(l) !=
// key(j), l's shift the sum of k's and its own), then lanes gate the
// (a, e) pairs 32 at a time and append the torsions that pass to the queue
// (a, c, torsion type, e's row, slot, BO0 and bond, delta_ang(j) +
// delta_ang(k)); whenever 32 are queued, one lane each evaluates them.
// Reductions: the a-leg and central-bond gradients go to j's row
// accumulators in shared memory by shared atomics, and after the last
// torsion to device memory with one atomic add a nonzero value (other
// warps add to that row too); the e-leg and delta(k) gradients go to
// device memory by atomics, and delta(j)'s is summed per lane and reduced
// with shuffles.  Each center's two energies are reduced per warp and
// stored in its own slot of an (n,) buffer, summed afterwards, so the
// energies do not depend on the order of atomics; the torsions a center
// holds (the list build's gates) are stored beside them.
//
// Every output buffer is zeroed by the wrapper; the kernel allocates
// nothing and launches on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 2;                        // center rows per block
constexpr int kQ = 64;                           // queued torsions a warp
constexpr unsigned kFull = 0xffffffffu;
constexpr int kZeroCode = (4 * 9 + 4) * 9 + 4;  // the zero shift's code
constexpr int kJg = 10;  // j-row accumulator: 2 energies x (BO0, pi, drb)

template <typename T>
struct TorArgs {
  const T* bo0;                 // (N, kb) BO0 of each bonded slot
  const T* bopi;                // (N, kb) pi bond order
  const T* drb;                 // (N, kb, 3) r_row - r_neighbor
  const T* delta;               // (N,)
  const long long* types;       // (N,)
  const long long* gid;         // (N,)
  const unsigned char* amask;   // (N,) live centers
  const unsigned char* maskb;   // (N, kb) live bonded slots
  const long long* idxb;        // (N, kb) bonded ext indices
  const T* shift;               // (M, 3) lattice shift of each ext entry
  const T* Val;                 // (nso,)
  const T* Valangle;            // (nso,)
  const long long* inxn4;       // (nso, nso, nso, nso) torsion type, -1 none
  const T* torprm;              // (ntoty, 9): V1 V2 V3 ptor1-4 pcot1-2
  int n, N, kb, nso;
  long long nown;               // the owner row of ext entry e is e % nown
  T esub, minbo0, bound, nsmall, floor;
  T* e;                         // (2, n) each energy's part by center
  T* grad;                      // (2, 5 N kb + N): see `Out`
  int* rows;                    // (n,) torsions a center
};

// one energy's outputs: its part by center; dE/dBO0, dE/dpi, dE/ddrb and
// dE/ddelta, one after the other
template <typename T>
struct Out {
  T *e, *bo0, *pi, *drb, *delta;
};

template <typename T>
__device__ __forceinline__ Out<T> out_of(const TorArgs<T>& a, int s) {
  const size_t nk = (size_t)a.N * a.kb;
  Out<T> o;
  o.e = a.e + (size_t)s * a.n;
  o.bo0 = a.grad + (size_t)s * (5 * nk + a.N);
  o.pi = o.bo0 + nk;
  o.drb = o.pi + nk;
  o.delta = o.drb + 3 * nk;
  return o;
}

// a warp's shared memory: j's candidates and their gradient accumulators,
// owner(k)'s candidates of the current c, and the queue of torsions
template <typename T>
struct Rows {
  long long *jkey, *jext, *lkey;
  T *jbo, *jpi, *ju, *jn, *jdan, *jg, *lbo, *lu, *ln;
  T *qbl, *qu, *qn, *qdajk;
  int *jslot, *jo, *jt, *jfwd, *lslot, *lt;
  int *qac, *qt, *qrow, *qslot;
};

__host__ __device__ __forceinline__ size_t align16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

template <typename T>
__host__ __device__ __forceinline__ size_t warp_bytes(int K) {
  return align16(3 * sizeof(long long) * K +
                 sizeof(T) * ((7 + kJg + 5) * K + 6 * kQ) +
                 sizeof(int) * (6 * K + 4 * kQ));
}

template <typename T>
__device__ __forceinline__ Rows<T> carve(unsigned char* base, int K) {
  Rows<T> r;
  long long* q = (long long*)base;
  r.jkey = q;
  r.jext = q + K;
  r.lkey = q + 2 * K;
  T* t = (T*)(q + 3 * K);
  r.jbo = t;
  r.jpi = t + K;
  r.ju = t + 2 * K;
  r.jn = t + 5 * K;
  r.jdan = t + 6 * K;
  r.jg = t + 7 * K;
  t += (7 + kJg) * K;
  r.lbo = t;
  r.lu = t + K;
  r.ln = t + 4 * K;
  t += 5 * K;
  r.qbl = t;
  r.qu = t + kQ;
  r.qn = t + 4 * kQ;
  r.qdajk = t + 5 * kQ;
  int* i = (int*)(t + 6 * kQ);
  r.jslot = i;
  r.jo = i + K;
  r.jt = i + 2 * K;
  r.jfwd = i + 3 * K;
  r.lslot = i + 4 * K;
  r.lt = i + 5 * K;
  i += 6 * K;
  r.qac = i;
  r.qt = i + kQ;
  r.qrow = i + 2 * kQ;
  r.qslot = i + 3 * kQ;
  return r;
}

// float32 takes the card's fast forms (a few ulp), float64 the exact ones
__device__ __forceinline__ float exp_(float x) { return __expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float div_(float x, float y) {
  return __fdividef(x, y);
}
__device__ __forceinline__ double div_(double x, double y) { return x / y; }
// sqrt of x > 0
__device__ __forceinline__ float sqrt_(float x) { return x * rsqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float max_(float x, float y) { return fmaxf(x, y); }
__device__ __forceinline__ double max_(double x, double y) {
  return fmax(x, y);
}
__device__ __forceinline__ int rint_(float x) { return __float2int_rn(x); }
__device__ __forceinline__ int rint_(double x) { return __double2int_rn(x); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ T dot3(const T u[3], const T v[3]) {
  return u[0] * v[0] + u[1] * v[1] + u[2] * v[2];
}

template <typename T>
__device__ __forceinline__ void cross3(const T u[3], const T v[3], T w[3]) {
  w[0] = u[1] * v[2] - u[2] * v[1];
  w[1] = u[2] * v[0] - u[0] * v[2];
  w[2] = u[0] * v[1] - u[1] * v[0];
}

// the integer shift of ext entry e, as reax._shift_code rounds it
template <typename T>
__device__ __forceinline__ void shift_of(const TorArgs<T>& a, long long e,
                                         int s[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) s[c] = rint_(__ldg(a.shift + 3 * e + c));
}

__device__ __forceinline__ int code_of(const int s[3]) {
  return ((s[0] + 4) * 9 + (s[1] + 4)) * 9 + (s[2] + 4);
}

// drb's length and unit vector
template <typename T>
__device__ __forceinline__ void stage_bond(const T v[3], T* u, T* n) {
  const T len = sqrt_(dot3(v, v));
  const T inv = div_(T(1), len);
#pragma unroll
  for (int c = 0; c < 3; ++c) u[c] = v[c] * inv;
  *n = len;
}

// One torsion i-j-k-l from the unit vectors and lengths of rij = r_i -
// r_j, rjk = r_j - r_k, rkl = r_k - r_l; BO0 of its three bonds, the pi BO
// of j-k, delta_ang(j) + delta_ang(k) and its parameters (reax.
// torsion_energy's arithmetic, its clamps and their zero gradients).
// Returns E_tors and E_conj; g[s] holds energy s's gradient: BO0 of a, c,
// l; pi of c; rij, rjk, rkl; the delta_ang sum.
template <typename T>
struct Grad {
  T ba, bc, bl, pi, rij[3], rjk[3], rkl[3], dajk;
};

template <typename T>
__device__ __forceinline__ void torsion_one(
    const T uij[3], T nij, const T ujk[3], T njk, const T ukl[3], T nkl,
    T b_a, T b_c, T b_l, T pi_c, T dajk, const T* prm, T esub, T bound,
    T nsmall, T floor, T& et, T& ec, Grad<T>& gt, Grad<T>& gc) {
  const T V1 = __ldg(prm), V2 = __ldg(prm + 1), V3 = __ldg(prm + 2),
          p1 = __ldg(prm + 3), p2 = __ldg(prm + 4), p3 = __ldg(prm + 5),
          p4 = __ldg(prm + 6), pc1 = __ldg(prm + 7), pc2 = __ldg(prm + 8);
  // --- geometry (reax._angle_cos, _unit_cross, _clip_cos)
  const T c1r = -dot3(uij, ujk), c2r = -dot3(ujk, ukl);
  const bool m1 = c1r >= -bound && c1r <= bound;
  const bool m2 = c2r >= -bound && c2r <= bound;
  const T c1 = m1 ? c1r : (c1r < T(0) ? -bound : bound);
  const T c2 = m2 ? c2r : (c2r < T(0) ? -bound : bound);
  const T s1 = sqrt_(T(1) - c1 * c1), s2 = sqrt_(T(1) - c2 * c2);
  T x1[3], x2[3];
  cross3(uij, ujk, x1);
  cross3(ujk, ukl, x2);
  const T q1 = dot3(x1, x1), q2 = dot3(x2, x2);
  const T r1 = sqrt_(max_(q1, floor)), r2 = sqrt_(max_(q2, floor));
  const T n1 = max_(r1, nsmall), n2 = max_(r2, nsmall);
  const bool a1 = q1 >= floor && r1 >= nsmall;   // the floors let the
  const bool a2 = q2 >= floor && r2 >= nsmall;   // gradient through
  const T inn = div_(T(1), n1 * n2);
  const T cwr = dot3(x1, x2) * inn;
  const bool mw = cwr >= -bound && cwr <= bound;
  const T cw = mw ? cwr : (cwr < T(0) ? -bound : bound);
  const T cw2 = cw * cw;
  const T c2w = T(2) * cw2 - T(1);
  const T c3w = (T(4) * cw2 - T(3)) * cw;
  // --- bond-order factors (ref: pot.F90:1086-1129)
  const T bij = b_a - esub, bjk = b_c - esub, bkl = b_l - esub;
  const T eij = exp_(-p2 * bij), ejk = exp_(-p2 * bjk), ekl = exp_(-p2 * bkl);
  const T fij = T(1) - eij, fjk = T(1) - ejk, fkl = T(1) - ekl;
  const T half = T(0.5) * fij * fjk * fkl;        // fn10 / 2
  // fn11 = (2 + e^A) / (1 + e^A + e^B), A = -p3 dajk, B = p4 dajk, with
  // every exponent shifted below 0 (reax._ratio23)
  const T A = -p3 * dajk, B = p4 * dajk;
  const T m = max_(max_(A, B), T(0));
  const T ea = exp_(A - m), eb = exp_(B - m), e0 = exp_(-m);
  const T num = T(2) * e0 + ea, iden = div_(T(1), e0 + ea + eb);
  const T fn11 = num * iden;
  const T dfn11 = (ea * (eb - e0) * (-p3) - num * eb * p4) * iden * iden;
  const T dij = bij - T(1.5), djk = bjk - T(1.5), dkl = bkl - T(1.5);
  const T fn12 = exp_(-pc2 * (dij * dij + djk * djk + dkl * dkl));
  const T btb2 = T(2) - pi_c - fn11;
  const T et1 = exp_(p1 * btb2 * btb2);
  const T S = s1 * s2;
  const T brk = V1 * (T(1) + cw) + V2 * et1 * (T(1) - c2w) + V3 * (T(1) + c3w);
  const T conj = T(1) + (cw2 - T(1)) * S;
  et = half * S * brk;
  ec = pc1 * fn12 * conj;

  // --- adjoints of cos w and S, then of the bond orders
  const T gcw_t =
      half * S * (V1 - T(4) * V2 * et1 * cw + V3 * (T(12) * cw2 - T(3)));
  const T gS_t = half * brk;
  const T gfn10 = T(0.5) * S * brk * p2;
  const T gbtb2 = half * S * V2 * (T(1) - c2w) * et1 * T(2) * p1 * btb2;
  gt.ba = gfn10 * fjk * fkl * eij;
  gt.bc = gfn10 * fij * fkl * ejk;
  gt.bl = gfn10 * fij * fjk * ekl;
  gt.pi = -gbtb2;
  gt.dajk = -gbtb2 * dfn11;
  const T gcw_c = pc1 * fn12 * T(2) * cw * S;
  const T gS_c = pc1 * fn12 * (cw2 - T(1));
  const T g12 = pc1 * conj * fn12 * T(-2) * pc2;
  gc.ba = g12 * dij;
  gc.bc = g12 * djk;
  gc.bl = g12 * dkl;
  gc.pi = T(0);
  gc.dajk = T(0);

  // --- |r| dS/dr: S = sin1 sin2, sin = sqrt(1 - cos^2) of the clipped cos
  const T A1 = m1 ? div_(-c1 * s2, s1) : T(0);
  const T A2 = m2 ? div_(-c2 * s1, s2) : T(0);
  T sij[3], sjk[3], skl[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    sij[q] = A1 * (-ujk[q] - c1r * uij[q]);
    sjk[q] = A1 * (-uij[q] - c1r * ujk[q]) + A2 * (-ukl[q] - c2r * ujk[q]);
    skl[q] = A2 * (-ujk[q] - c2r * ukl[q]);
  }
  // --- |r| dcos w/dr through the unit vectors and their cross products
  T wij[3] = {T(0), T(0), T(0)}, wjk[3] = {T(0), T(0), T(0)},
    wkl[3] = {T(0), T(0), T(0)};
  if (mw) {
    const T k1 = a1 ? cwr * div_(T(1), n1 * n1) : T(0);
    const T k2 = a2 ? cwr * div_(T(1), n2 * n2) : T(0);
    T g1[3], g2[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      g1[q] = x2[q] * inn - k1 * x1[q];
      g2[q] = x1[q] * inn - k2 * x2[q];
    }
    T t[3];
    cross3(ujk, g1, wij);
    cross3(g1, uij, wjk);
    cross3(ukl, g2, t);
    cross3(g2, ujk, wkl);
#pragma unroll
    for (int q = 0; q < 3; ++q) wjk[q] += t[q];
    const T pij = dot3(wij, uij), pjk = dot3(wjk, ujk), pkl = dot3(wkl, ukl);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      wij[q] -= pij * uij[q];
      wjk[q] -= pjk * ujk[q];
      wkl[q] -= pkl * ukl[q];
    }
  }
  const T iij = div_(T(1), nij), ijk = div_(T(1), njk), ikl = div_(T(1), nkl);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    gt.rij[q] = (gcw_t * wij[q] + gS_t * sij[q]) * iij;
    gt.rjk[q] = (gcw_t * wjk[q] + gS_t * sjk[q]) * ijk;
    gt.rkl[q] = (gcw_t * wkl[q] + gS_t * skl[q]) * ikl;
    gc.rij[q] = (gcw_c * wij[q] + gS_c * sij[q]) * iij;
    gc.rjk[q] = (gcw_c * wjk[q] + gS_c * sjk[q]) * ijk;
    gc.rkl[q] = (gcw_c * wkl[q] + gS_c * skl[q]) * ikl;
  }
}

// adds v to *p unless it is zero (an untouched accumulator)
template <typename T>
__device__ __forceinline__ void add_nz(T* p, T v) {
  if (v != T(0)) atomicAdd(p, v);
}

// the segments of equal `key` over the warp's lanes: the first lane of
// this lane's segment, and whether this lane is its last
struct Seg {
  int first;
  bool tail;
};

__device__ __forceinline__ Seg segment(int key, int lane) {
  const int prev = __shfl_up_sync(kFull, key, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != key);
  Seg s;
  s.first = 31 - __clz(heads & (kFull >> (31 - lane)));
  s.tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
  return s;
}

// the sum of v over this lane's segment up to this lane
template <typename T>
__device__ __forceinline__ T seg_sum(T v, const Seg& s, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T u = __shfl_up_sync(kFull, v, d);
    if (lane - d >= s.first) v += u;
  }
  return v;
}

// queued torsion q, the lane's own where `live` (every lane calls): its
// energies to e_t, e_c; its e-leg and delta(k) gradients to device memory,
// delta(j)'s to gdj; its a-leg and central-bond gradients to j's
// accumulators, summed first over the lanes of equal a and of equal c (the
// queue holds a center's torsions in (c, a, e) order, so equal ones are
// neighbours) and added by the last lane of each
template <typename T>
__device__ __forceinline__ void evaluate(const TorArgs<T>& a,
                                         const Rows<T>& r, int q, bool live,
                                         int lane, int K, const Out<T>& ot,
                                         const Out<T>& oc, T& e_t, T& e_c,
                                         T& gdj) {
  int ai = -1 - lane, ci = -1 - lane;           // dead lanes: alone
  T va[8] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  T vc[kJg] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  if (live) {
    ai = r.qac[q] & 0xffff;
    ci = r.qac[q] >> 16;
    const T uij[3] = {-r.ju[3 * ai], -r.ju[3 * ai + 1], -r.ju[3 * ai + 2]};
    const T ujk[3] = {r.ju[3 * ci], r.ju[3 * ci + 1], r.ju[3 * ci + 2]};
    const T ukl[3] = {r.qu[3 * q], r.qu[3 * q + 1], r.qu[3 * q + 2]};
    T et, ec;
    Grad<T> gt, gc;
    torsion_one(uij, r.jn[ai], ujk, r.jn[ci], ukl, r.qn[q], r.jbo[ai],
                r.jbo[ci], r.qbl[q], r.jpi[ci], r.qdajk[q],
                a.torprm + 9 * r.qt[q], a.esub, a.bound, a.nsmall, a.floor,
                et, ec, gt, gc);
    e_t += et;
    e_c += ec;
    gdj += gt.dajk;
    const int row = r.qrow[q];
    const size_t lq = (size_t)row * K + r.qslot[q];
    add_nz(ot.bo0 + lq, gt.bl);
    add_nz(oc.bo0 + lq, gc.bl);
    add_nz(ot.delta + row, gt.dajk);
    // j's accumulator layout: per energy BO0, pi, drb[3]
    va[0] = gt.ba;
    va[4] = gc.ba;
    vc[0] = gt.bc;
    vc[1] = gt.pi;
    vc[5] = gc.bc;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      add_nz(ot.drb + 3 * lq + c, gt.rkl[c]);
      add_nz(oc.drb + 3 * lq + c, gc.rkl[c]);
      va[1 + c] = -gt.rij[c];                     // drb[j, a] = -rij
      va[5 + c] = -gc.rij[c];
      vc[2 + c] = gt.rjk[c];
      vc[7 + c] = gc.rjk[c];
    }
  }
  const Seg sa = segment(ai, lane);
#pragma unroll
  for (int v = 0; v < 8; ++v) va[v] = seg_sum(va[v], sa, lane);
  if (live && sa.tail) {
    T* ja = r.jg + kJg * ai;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      atomicAdd(ja + (v ? 1 + v : 0), va[v]);     // BO0, drb: not pi
      atomicAdd(ja + 5 + (v ? 1 + v : 0), va[4 + v]);
    }
  }
  const Seg sc = segment(ci, lane);
#pragma unroll
  for (int v = 0; v < kJg; ++v) vc[v] = seg_sum(vc[v], sc, lane);
  if (live && sc.tail) {
    T* jc = r.jg + kJg * ci;
#pragma unroll
    for (int v = 0; v < kJg; ++v) atomicAdd(jc + v, vc[v]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
torsion_kernel(const TorArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + w;
  if (j >= a.n || !a.amask[j]) return;        // the whole warp
  const int K = a.kb;
  const Rows<T> r = carve<T>(smem + w * warp_bytes<T>(K), K);
  const unsigned below = (1u << lane) - 1u;
  const Out<T> ot = out_of(a, 0), oc = out_of(a, 1);

  // j's candidate slots, in slot order; every load a lane may need is
  // issued before the ones that depend on it
  const int tj = (int)a.types[j];
  const long long gj = a.gid[j];
  const T delta_j = a.delta[j];
  int nj = 0;
  for (int s0 = 0; s0 < K; s0 += 32) {
    const int s = s0 + lane;
    const size_t q = (size_t)j * K + s;
    bool ok = false;
    T b = T(0), pi = T(0), d[3] = {T(0), T(0), T(0)};
    long long k = 0;
    if (s < K) {
      ok = a.maskb[q];
      b = a.bo0[q];
      pi = a.bopi[q];
      k = a.idxb[q];
#pragma unroll
      for (int c = 0; c < 3; ++c) d[c] = a.drb[3 * q + c];
      ok = ok && b > a.esub;
    }
    const unsigned m = __ballot_sync(kFull, ok);
    if (ok) {
      const int p = nj + __popc(m & below);
      const int o = (int)(k % a.nown);
      int sh[3];
      shift_of(a, k, sh);
      const int t = (int)a.types[o];
      const long long go = a.gid[o];
      const T del = a.delta[o];
      r.jslot[p] = s;
      r.jbo[p] = b;
      r.jpi[p] = pi;
      stage_bond(d, r.ju + 3 * p, r.jn + p);
      r.jo[p] = o;
      r.jt[p] = t;
      r.jfwd[p] = gj < go;                    // the bond once, from j
      r.jdan[p] = (del + a.Val[t]) - a.Valangle[t];
      r.jext[p] = k;
      r.jkey[p] = (long long)o * 729 + code_of(sh);
    }
    nj += __popc(m);
  }
  for (int q = lane; q < kJg * nj; q += 32) r.jg[q] = T(0);
  __syncwarp();

  const T dan_j = (delta_j + a.Val[tj]) - a.Valangle[tj];
  const long long keyj = (long long)j * 729 + kZeroCode;
  const long long nso = a.nso;
  T e_t = T(0), e_c = T(0), gdj = T(0);
  int cnt = 0, nq = 0;
  for (int ci = 0; ci < nj; ++ci) {
    if (!r.jfwd[ci]) continue;
    const int ok_row = r.jo[ci];
    const int tk = r.jt[ci];
    const T b_c = r.jbo[ci];
    int sk[3];
    shift_of(a, r.jext[ci], sk);

    // owner(k)'s candidates e with l's image translated by k's shift
    int nl = 0;
    for (int s0 = 0; s0 < K; s0 += 32) {
      const int s = s0 + lane;
      const size_t q = (size_t)ok_row * K + s;
      bool ok = false;
      T b = T(0), d[3] = {T(0), T(0), T(0)};
      long long l = 0;
      if (s < K) {
        ok = a.maskb[q];
        b = a.bo0[q];
        l = a.idxb[q];
#pragma unroll
        for (int c = 0; c < 3; ++c) d[c] = a.drb[3 * q + c];
        ok = ok && b > a.esub && b_c * b > a.esub;
      }
      long long key = 0;
      int ol = 0;
      if (ok) {
        ol = (int)(l % a.nown);
        int sl[3];
        shift_of(a, l, sl);
#pragma unroll
        for (int c = 0; c < 3; ++c) sl[c] += sk[c];
        key = (long long)ol * 729 + code_of(sl);
        ok = key != keyj;                     // l != j
      }
      const unsigned m = __ballot_sync(kFull, ok);
      if (ok) {
        const int p = nl + __popc(m & below);
        r.lslot[p] = s;
        r.lbo[p] = b;
        stage_bond(d, r.lu + 3 * p, r.ln + p);
        r.lkey[p] = key;
        r.lt[p] = (int)a.types[ol];
      }
      nl += __popc(m);
    }
    __syncwarp();
    if (nl == 0) continue;

    const T dajk = dan_j + r.jdan[ci];
    const long long t4jk = ((long long)tj * nso + tk) * nso;  // [., tj, tk, .]
    const int np = nj * nl;
    for (int p0 = 0; p0 < np; p0 += 32) {
      const int p = p0 + lane;
      const int ai = p / nl, ei = p - ai * nl;
      long long t = -1;
      if (p < np && ai != ci) {
        const T b_a = r.jbo[ai], b_l = r.lbo[ei];
        // the list build's gates, then the evaluation's order of products
        if (b_a * b_c > a.esub && b_a * (b_c * b_c) * b_l > a.minbo0 &&
            r.jkey[ai] != r.lkey[ei]) {
          t = __ldg(a.inxn4 + r.jt[ai] * nso * nso * nso + t4jk + r.lt[ei]);
          if (t >= 0) {
            ++cnt;
            if (!(b_a * b_c * b_c * b_l > a.minbo0)) t = -1;
          }
        }
      }
      const unsigned m = __ballot_sync(kFull, t >= 0);
      if (t >= 0) {
        const int q = nq + __popc(m & below);
        r.qac[q] = ai | (ci << 16);
        r.qt[q] = (int)t;
        r.qrow[q] = ok_row;
        r.qslot[q] = r.lslot[ei];
        r.qbl[q] = r.lbo[ei];
#pragma unroll
        for (int c = 0; c < 3; ++c) r.qu[3 * q + c] = r.lu[3 * ei + c];
        r.qn[q] = r.ln[ei];
        r.qdajk[q] = dajk;
      }
      nq += __popc(m);
      if (nq >= 32) {                         // the last 32 on full lanes
        __syncwarp();
        evaluate(a, r, nq - 32 + lane, true, lane, K, ot, oc, e_t, e_c, gdj);
        nq -= 32;
        __syncwarp();
      }
    }
    __syncwarp();                 // the next c rewrites owner(k)'s arrays
  }
  if (nq > 0) {
    __syncwarp();
    evaluate(a, r, lane, lane < nq, lane, K, ot, oc, e_t, e_c, gdj);
  }
  e_t = warp_sum(e_t);
  e_c = warp_sum(e_c);
  gdj = warp_sum(gdj);
  cnt = warp_sum(cnt);
  __syncwarp();
  if (lane == 0) {
    ot.e[j] = e_t;
    oc.e[j] = e_c;
    add_nz(ot.delta + j, gdj);
    a.rows[j] = cnt;
  }
  for (int s = lane; s < nj; s += 32) {
    const size_t q = (size_t)j * K + r.jslot[s];
    const T* ja = r.jg + kJg * s;
    add_nz(ot.bo0 + q, ja[0]);
    add_nz(ot.pi + q, ja[1]);
    add_nz(oc.bo0 + q, ja[5]);
    add_nz(oc.pi + q, ja[6]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      add_nz(ot.drb + 3 * q + c, ja[2 + c]);
      add_nz(oc.drb + 3 * q + c, ja[7 + c]);
    }
  }
}

template <typename T>
int launch(const TorArgs<T>& a, cudaStream_t stream) {
  if (a.n == 0) return 0;
  const size_t smem = kWarps * warp_bytes<T>(a.kb);
  static size_t allowed = 48 * 1024;   // past it only after the attribute
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        torsion_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  const dim3 grid((a.n + kWarps - 1) / kWarps), block(kWarps * 32);
  torsion_kernel<T><<<grid, block, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int entry(const void* bo0, const void* bopi, const void* drb,
          const void* delta, const void* types, const void* gid,
          const void* amask, const void* maskb, const void* idxb,
          const void* shift, const void* Val, const void* Valangle,
          const void* inxn4, const void* torprm, int n, int N, int kb,
          int nso, long long nown, double esub, double minbo0,
          double cos_bound, double nsmall, double floor, void* e,
          void* grad, void* rows, void* stream) {
  TorArgs<T> a;
  a.bo0 = (const T*)bo0;
  a.bopi = (const T*)bopi;
  a.drb = (const T*)drb;
  a.delta = (const T*)delta;
  a.types = (const long long*)types;
  a.gid = (const long long*)gid;
  a.amask = (const unsigned char*)amask;
  a.maskb = (const unsigned char*)maskb;
  a.idxb = (const long long*)idxb;
  a.shift = (const T*)shift;
  a.Val = (const T*)Val;
  a.Valangle = (const T*)Valangle;
  a.inxn4 = (const long long*)inxn4;
  a.torprm = (const T*)torprm;
  a.n = n;
  a.N = N;
  a.kb = kb;
  a.nso = nso;
  a.nown = nown;
  a.esub = (T)esub;
  a.minbo0 = (T)minbo0;
  a.bound = (T)cos_bound;
  a.nsmall = (T)nsmall;
  a.floor = (T)floor;
  a.e = (T*)e;
  a.grad = (T*)grad;
  a.rows = (int*)rows;
  return launch(a, (cudaStream_t)stream);
}

}  // namespace

// dtype 0: float32, 1: float64
extern "C" int rxmd_torsion(int dtype, const void* bo0, const void* bopi,
                            const void* drb, const void* delta,
                            const void* types, const void* gid,
                            const void* amask, const void* maskb,
                            const void* idxb, const void* shift,
                            const void* Val, const void* Valangle,
                            const void* inxn4, const void* torprm, int n,
                            int N, int kb, int nso, long long nown,
                            double esub, double minbo0, double cos_bound,
                            double nsmall, double floor, void* e,
                            void* grad, void* rows, void* stream) {
  if (dtype)
    return entry<double>(bo0, bopi, drb, delta, types, gid, amask, maskb,
                         idxb, shift, Val, Valangle, inxn4, torprm, n, N, kb,
                         nso, nown, esub, minbo0, cos_bound, nsmall, floor,
                         e, grad, rows, stream);
  return entry<float>(bo0, bopi, drb, delta, types, gid, amask, maskb, idxb,
                      shift, Val, Valangle, inxn4, torprm, n, N, kb, nso,
                      nown, esub, minbo0, cos_bound, nsmall, floor, e, grad,
                      rows, stream);
}

extern "C" const char* rxmd_torsion_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
