// The rigid-fluid coupling steps' fluid pair passes on the spill cell grid.
//
// Replaces the TPU kernels of rigid_body_2d_3d_pysph_tpu/ops/pallas_fluid.py
// (the _scaffold / cell_pair_pallas scaffold with five compute bodies).
// The fused kdkf step runs the first two, the kdk and reference orderings
// the split passes:
//
//   fluid_rates_wall      fluid_rates_wall_pallas :364 (B4) -> [NC, M, 7]
//                         arho, ap (fluid queries); uf, vf, wf, sw, p_num
//                         (wall and body queries, the Adami sums)
//   fluid_forces_contact  fluid_forces_contact_pallas :590 (B5, _forces_cols
//                         :494 + pallas_contact._pair_body(union=True))
//                         -> [NC, M, 12 S + 6]: the Mofidi contact columns
//                         in K2's order, then au, av, aw, fx, fy, fz
//   fluid_rates           fluid_rates_pallas :302 (B6a) -> [NC, M, 2],
//                         B4's rates alone, the fluid/boundary and the
//                         FSI-rigid source classes summed apart
//   wall_bc               wall_bc_pallas :460 (B6b) -> [NC, M, 5], B4's
//                         wall sums alone
//   fluid_forces          fluid_forces_pallas :562 (B6c) -> [NC, M, 6],
//                         the forces alone (B5 without its contact part),
//                         with or without the FSI terms
//
// Inputs: the coupling pack dft [NC + 1, 14, M] (x y z u v w m rho h p
// m_fsi rho_fsi p_fsi flags; flags = dem*16 + cfib*8 + static_boundary*4 +
// fluid*2 + rigid, sentinel -16) and the stencil rows nbr [NC, O] (int64,
// NC = no neighbour).  Query slot s is row s of the pack; sources are the
// rows nbr[s][0..O), M lanes each, visited in that order.  Every output row
// is written: a sentinel query lane gets zeros (and the contact init row).
//
// Bound on the card: latency and instruction issue, not bytes.  The pack
// is 56 bytes a lane and every query lane tests O x M candidate lanes,
// about a tenth of them in range.  The rates and wall passes (B4, B6a,
// B6b): one thread per query lane, blocks of 128 threads (8 slots of
// M = 16), each thread scanning its slot's stencil rows in order with
// every sum in a register; the 16 threads of a slot read the same source
// word at once (a broadcast through the read-only cache).  The forces
// passes (B5, B6c) run one warp a slot over candidates staged in shared
// memory (see forces_kernel): a one-lane scan there ran each pair body
// for the whole warp whenever one of its lanes had a pair in range, and
// wrote B5's 12 S + 6 columns a lane at a stride.  The compile-time
// choices of the TPU kernels (EDAC, rigid bodies present, artificial
// viscosity on, the kernel's dimension) are template parameters, not
// branches per pair.
//
// Built with --fmad=false, so every per-pair term rounds as the plain
// PyTorch version's does: the contact picks are bit for bit the plain
// version's, the sums differ only in summation order.
#include <cmath>

#include "mofidi.cuh"

namespace {

enum {
  FX, FY, FZ, FU, FV, FW, FM, FRHO, FH, FP, FMFSI, FRHOFSI, FPFSI, FFLAGS,
  NF
};
constexpr int kThreads = 128;

struct Flags {
  float dem, cfib, sbdry, fluid, rigid;
};

__device__ __forceinline__ Flags decode(float f) {
  Flags d;
  d.dem = floorf(f * (1.0f / 16.0f));
  float r = f - 16.0f * d.dem;
  d.cfib = floorf(r * 0.125f);
  r = r - 8.0f * d.cfib;
  d.sbdry = floorf(r * 0.25f);
  r = r - 4.0f * d.sbdry;
  d.fluid = floorf(r * 0.5f);
  d.rigid = r - 2.0f * d.fluid;
  return d;
}

__device__ __forceinline__ float field(const float* row, int f, int M, int l) {
  return __ldg(row + f * M + l);
}

// dW/dr / r of the quintic spline with the guarded 1/r (0 at r = 0), and
// W from the same q and sigma (ops/kernels.py QuinticSpline.w_gradw)
template <bool KDIM2>
__device__ __forceinline__ void quintic_w_gradw(float rij, float h,
                                                float sig_num, float sig_den,
                                                float& w, float& dw) {
  const float q = rij / h;
  const float t3 = fmaxf(3.0f - q, 0.0f);
  const float t2 = fmaxf(2.0f - q, 0.0f);
  const float t1 = fmaxf(1.0f - q, 0.0f);
  const float t3_4 = mofidi::pow4(t3), t2_4 = mofidi::pow4(t2),
              t1_4 = mofidi::pow4(t1);
  const float sig = mofidi::quintic_sigma<KDIM2>(h, sig_num, sig_den);
  w = sig * (t3_4 * t3 - 6.0f * (t2_4 * t2) + 15.0f * (t1_4 * t1));
  const float dval = -5.0f * t3_4 + 30.0f * t2_4 - 75.0f * t1_4;
  const float inv = rij > 1e-12f ? 1.0f / fmaxf(rij, 1e-12f) : 0.0f;
  dw = sig * dval / h * inv;
}

template <bool KDIM2>
__device__ __forceinline__ float quintic_gradw(float rij, float h,
                                               float sig_num, float sig_den) {
  float w, dw;
  quintic_w_gradw<KDIM2>(rij, h, sig_num, sig_den, w, dw);
  return dw;
}

// ---------------------------------------------------------------------------
// B4: rates (fluid queries) and the Adami wall sums (wall and body queries)
// in one sweep; B6a the rates alone, B6b the wall sums alone
// ---------------------------------------------------------------------------

// which columns a rates/wall instance writes
enum { kRatesWall = 0, kRates = 1, kWall = 2 };

template <bool KDIM2, bool EDAC, bool HAS_RIGID, int MODE>
__global__ void rates_wall_kernel(const float* __restrict__ dft,
                                  const long long* __restrict__ nbr,
                                  float* __restrict__ out, int NC, int O,
                                  int M, float cutoff, float nu2, float cs2,
                                  float gx, float gy, float gz, float sig_num,
                                  float sig_den) {
  constexpr bool RATES = MODE != kWall, WALL = MODE != kRates;
  // B6a sums the fluid/boundary and the FSI-rigid source classes apart
  // (pallas_fluid.py:348-351), B4 in one term (:423-433)
  constexpr bool SPLIT = MODE == kRates && HAS_RIGID;
  constexpr int W = MODE == kRatesWall ? 7 : (MODE == kRates ? 2 : 5);
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long slot = g / M;
  const int l = (int)(g - slot * M);
  if (slot >= NC) return;
  const float* q = dft + slot * NF * M;
  const Flags qf = decode(field(q, FFLAGS, M, l));
  const bool dest_fluid = RATES && qf.fluid == 1.0f;
  const bool dest_solid = WALL && (qf.sbdry == 1.0f || qf.rigid == 1.0f);

  // arho2, ap2: the FSI-rigid class of B6a
  float arho = 0.f, ap = 0.f, arho2 = 0.f, ap2 = 0.f;
  float uf = 0.f, vf = 0.f, wf = 0.f, sw = 0.f, pn = 0.f;
  if (dest_fluid || dest_solid) {
    const float qx = field(q, FX, M, l), qy = field(q, FY, M, l),
                qz = field(q, FZ, M, l);
    const float qu = field(q, FU, M, l), qv = field(q, FV, M, l),
                qw = field(q, FW, M, l);
    const float mi = field(q, FM, M, l), rhoi = field(q, FRHO, M, l);
    const float qh = field(q, FH, M, l), pi = field(q, FP, M, l);
    const float inv_m = 1.0f / fmaxf(mi, 1e-30f);
    const float Vi = mi / rhoi;
    for (int o = 0; o < O; ++o) {
      const long long sl = nbr[slot * O + o];
      if (sl < 0 || sl >= NC) continue;   // no neighbour: the sentinel row
      const float* s = dft + sl * NF * M;
      for (int k = 0; k < M; ++k) {
        const float xij = qx - field(s, FX, M, k);
        const float yij = qy - field(s, FY, M, k);
        const float zij = qz - field(s, FZ, M, k);
        const float r2 = xij * xij + yij * yij + zij * zij;
        const float rij = sqrtf(r2);
        if (!(rij <= cutoff)) continue;
        const Flags sf = decode(field(s, FFLAGS, M, k));
        const bool src_fluid = sf.fluid == 1.0f;
        const bool src_flbd = src_fluid || sf.sbdry == 1.0f;
        const bool src_rigid = sf.rigid == 1.0f;
        const bool rates =
            dest_fluid && (src_flbd || (HAS_RIGID && src_rigid));
        const bool wall = dest_solid && src_fluid;
        if (!(rates || wall)) continue;
        const float hij = 0.5f * (qh + field(s, FH, M, k));
        float w, dw;
        quintic_w_gradw<KDIM2>(rij, hij, sig_num, sig_den, w, dw);
        if (rates) {
          const bool fsi = HAS_RIGID && src_rigid;
          const float mj = field(s, fsi ? FMFSI : FM, M, k);
          const float rhoj = field(s, fsi ? FRHOFSI : FRHO, M, k);
          const float dwx = dw * xij, dwy = dw * yij, dwz = dw * zij;
          const float vdotdw = (qu - field(s, FU, M, k)) * dwx +
                               (qv - field(s, FV, M, k)) * dwy +
                               (qw - field(s, FW, M, k)) * dwz;
          const float da = rhoi * mj / rhoj * vdotdw;
          float dp = 0.f;
          if (EDAC) {
            const float pj = field(s, fsi ? FPFSI : FP, M, k);
            const float xdotdw = xij * dwx + yij * dwy + zij * dwz;
            const float eps = 0.01f * hij * hij;
            const float ap1 = rhoi / rhoj * cs2 * mj * vdotdw;
            const float Vj = mj / rhoj;
            const float etaij = nu2 * (rhoi * rhoj) / (rhoi + rhoj);
            const float tmp = inv_m * (Vi * Vi + Vj * Vj) * etaij * xdotdw /
                              (r2 + eps);
            dp = ap1 + tmp * (pi - pj);
          }
          if (SPLIT && fsi) {
            arho2 += da;
            ap2 += dp;
          } else {
            arho += da;
            ap += dp;
          }
        }
        if (wall) {
          const float gdotx = gx * xij + gy * yij + gz * zij;
          uf += field(s, FU, M, k) * w;
          vf += field(s, FV, M, k) * w;
          wf += field(s, FW, M, k) * w;
          sw += w;
          pn += (field(s, FP, M, k) + field(s, FRHO, M, k) * gdotx) * w;
        }
      }
    }
  }
  float* o = out + (slot * M + l) * W;
  if (RATES) {
    o[0] = SPLIT ? arho + arho2 : arho;
    o[1] = SPLIT ? ap + ap2 : ap;
    o += 2;
  }
  if (WALL) {
    o[0] = uf;
    o[1] = vf;
    o[2] = wf;
    o[3] = sw;
    o[4] = pn;
  }
}

// ---------------------------------------------------------------------------
// B5 / B6c: pressure gradient + artificial viscosity; with FSI (rigid
// bodies present) the FSI source class and the fluid -> rigid force; with
// CONTACT the Mofidi contact columns on the union layout first.  B5 is
// FSI and CONTACT, B6c FSI (kdk and reference orderings) or neither.
//
// One warp a query slot (kWarps slots a block), every sum in a fixed
// order:
// 1. The slot's query lanes: the lanes a force sum runs for (fluid, and
//    rigid with FSI) are listed by a ballot; a slot with none writes its
//    rows (zeros and the contact init row) and stops.
// 2. Staging: the warp walks the stencil in order, 32 / M entries a
//    step and kUnroll steps' loads in flight, and copies the candidates
//    a sum can use (fluid, boundary, FSI-rigid, contact-eligible) into
//    shared memory in stencil order, as structure of arrays of what the
//    bodies read: x y z h u v w, the source class's m and p / rho^2
//    (m_fsi and p_fsi / rho_fsi^2 for an FSI-rigid source, the same
//    rounding as the per-pair division), rho, and the class bits with
//    the dem.  Missing stencil entries cost nothing past their index;
//    sentinel lanes go no further.  A stencil with more than kCap
//    candidates is staged and summed in windows of whole entries,
//    carried in order.
// 3. Forces: with q listed queries, thread (i, p) takes query i and the
//    staged candidates p, p + P, p + 2P, ... (P = 32 / q), 32 at a time:
//    first the range tests (r2 <= r2max, the exact image of r <= cutoff,
//    and the classes the query sums), then the bodies of the pairs that
//    passed, each the one-lane kernel's arithmetic, so the warp runs as
//    many bodies as its busiest thread has pairs.  The P partial sums of
//    a query are added by a shuffle tree of fixed shape.
// 4. Contact (B5, slots with a rigid lane): the staged candidates that
//    pass the flag part of the gate (contact boundary, not fluid, a dem
//    some rigid lane of the slot wants) are listed in stencil order, and
//    one thread a (rigid lane, entity slot s != its dem) walks that list,
//    adding its gated pairs (dem s, r <= cutoff) into a mofidi::Acc in
//    stencil order: the sums and the pick are a sequential walk's, bit
//    for bit the one-lane kernel's.  This runs after the force sums (so
//    the two sets of running sums never share the registers), on the
//    staged window when one window held the stencil, else over the
//    windows staged again; more than 32 such threads run in groups.
// 5. The slot's [M, W] block is assembled in shared memory (the zero and
//    init rows, then the force and contact columns) and written
//    contiguously with 16-byte stores.
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;         // query slots a block, one warp each
constexpr int kCap = 160;         // staged candidates a window
constexpr int kUnroll = 2;        // stencil steps whose loads are in flight
constexpr int kMaxSmem = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;
// staged fields (rows of kCap words) and the class bits of a candidate
// (its dem above them)
enum { SX, SY, SZ, SH, SU, SV, SW, SMJ, SRHO, SPT, SCLS, NS };
enum { kSrcFluid = 1, kSrcFlbd = 2, kSrcRigid = 4 };
// the pack fields staging loads for every lane of an entry
constexpr int kLoads = 11;        // x y z u v w m rho h p flags

// a warp's shared memory in words: staging, the contact list, the query
// and rigid lane lists (32 each), the output block
__host__ __device__ constexpr int forces_warp_words(int M, int W) {
  return NS * kCap + kCap + 64 + ((M * W + 3) & ~3);
}

template <bool KDIM2, bool VISC, bool FSI, bool CONTACT>
__global__ void __launch_bounds__(kWarps * 32, CONTACT ? 5 : 6)
    forces_kernel(const float* __restrict__ dft,
                  const long long* __restrict__ nbr, float* __restrict__ out,
                  int NC, int O, int M, int S, float r2max,
                  float alpha_c0, float init_dist, float sig_num,
                  float sig_den) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const long long slot =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (slot >= NC) return;                    // the whole warp
  const int W = CONTACT ? 12 * S + 6 : 6;
  const int F0 = CONTACT ? 12 * S : 0;       // the first force column
  float* st = reinterpret_cast<float*>(smem4) +
              (threadIdx.x >> 5) * forces_warp_words(M, W);
  int* clist = reinterpret_cast<int*>(st + NS * kCap);
  int* qlist = clist + kCap;
  int* rlist = qlist + 32;
  float* obuf = st + NS * kCap + kCap + 64;
  float* orow = out + slot * M * W;
  const unsigned lt = (1u << lane) - 1u;
  const float* q = dft + slot * NF * M;
  const bool vec = (M * W) % 4 == 0 &&
                   (reinterpret_cast<unsigned long long>(out) & 15ull) == 0;
  // the default rows (zeros, and the contact init row in block 5) over
  // the slot's block at o: each thread steps its column on, no division
  // an element
  auto fill_default = [&](float* o, bool by4) {
    const int w = by4 ? 4 : 1, step = (32 * w) % W;
    int c = (w * lane) % W;
    auto at = [&](int j) -> float {
      const int cj = c + j < W ? c + j : c + j - W;
      return (CONTACT && cj >= 5 * S && cj < 6 * S) ? init_dist : 0.0f;
    };
    for (int i = lane; i < M * W / w; i += 32) {
      if (by4)
        reinterpret_cast<float4*>(o)[i] = make_float4(at(0), at(1), at(2),
                                                      at(3));
      else
        o[i] = at(0);
      c += step;
      if (c >= W) c -= W;
    }
  };

  // the stencil row 32 entries at a time, lane j holding entry nb_base + j
  // (loaded beside the query flags: one wait for both)
  const long long* nb = nbr + slot * O;
  int nb_base = 0;
  long long nb_lane = lane < O ? nb[lane] : -1LL;

  // 1. the query lanes
  Flags qf{-1.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (lane < M) qf = decode(__ldg(q + FFLAGS * M + lane));
  const bool act = qf.fluid == 1.0f || (FSI && qf.rigid == 1.0f);
  const bool rig = CONTACT && qf.rigid == 1.0f;
  const unsigned amask = __ballot_sync(kFull, act);
  const unsigned rmask = __ballot_sync(kFull, rig);
  const int nq = __popc(amask), nr = __popc(rmask);
  if (nq == 0) {
    fill_default(orow, vec);
    return;
  }
  if (act) qlist[__popc(amask & lt)] = lane;
  if (rig) rlist[__popc(rmask & lt)] = lane;
  fill_default(obuf, (M * W) % 4 == 0);
  // the dems the slot's rigid lanes want: every s but their own, so all
  // of them unless the rigid lanes share one dem
  int skip_dem = -1;
  if (CONTACT && nr > 0) {
    const int d = (int)qf.dem;
    const int lo = __reduce_min_sync(kFull, rig ? d : 0x7fffffff);
    const int hi = __reduce_max_sync(kFull, rig ? d : -0x7fffffff);
    if (lo == hi) skip_dem = lo;
  }
  __syncwarp();

  // the force sums' threads: query fi, candidates fp, fp + P, ...
  const int P = 32 / nq;
  const int fi = lane / P, fp = lane - fi * P;
  const bool fact = fi < nq;

  // 2. staging: the window of candidates from stencil entry e on; returns
  // the first entry not staged (O: the stencil's end)
  const int E = 32 / M;                      // stencil entries a step
  const int sj = lane / M, sk = lane - sj * M;
  const bool in_step = sj < E;
  const unsigned step_lanes = E * M == 32 ? kFull : (1u << (E * M)) - 1u;
  const unsigned upto = !in_step ? step_lanes
                        : (sj + 1) * M == 32 ? kFull
                                             : (1u << ((sj + 1) * M)) - 1u;
  auto stage = [&](int e, int& n, int& cn) -> int {
    n = 0;
    cn = 0;
    for (; e < O; e += kUnroll * E) {
      if (e < nb_base || e + kUnroll * E > nb_base + 32) {
        nb_base = e;                         // warp-uniform
        nb_lane = e + lane < O ? nb[e + lane] : -1LL;
      }
      long long rows[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int ee = e + u * E + sj;
        const long long r = __shfl_sync(kFull, nb_lane, (ee - nb_base) & 31);
        rows[u] = (in_step && ee < O) ? r : -1LL;
      }
      float v[kUnroll][kLoads];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool ok = rows[u] >= 0 && rows[u] < NC;
        const float* s = dft + (ok ? rows[u] : 0LL) * NF * M + sk;
#pragma unroll
        for (int f = 0; f < kLoads; ++f)
          v[u][f] = ok ? __ldg(s + (f < kLoads - 1 ? f : FFLAGS) * M) : 0.f;
        if (!ok) v[u][kLoads - 1] = -16.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // the flags word is an exact integer: decode() by shifts
        const int fl = (int)v[u][kLoads - 1];
        const int dem = fl >> 4;
        const bool s_fluid = fl & 2;
        const bool s_flbd = s_fluid || (fl & 4);
        const bool s_rigid = FSI && (fl & 1);
        const bool elig = CONTACT && nr > 0 && (fl & 8) && !s_fluid &&
                          dem >= 0 && dem < S && dem != skip_dem;
        const bool keep = s_flbd || s_rigid || elig;
        const unsigned bal = __ballot_sync(kFull, keep);
        // whole entries, in order, while the window has room
        const bool fits = n + __popc(bal & upto) <= kCap;
        const unsigned fitl = __ballot_sync(kFull, in_step && fits);
        const int pos = n + __popc(bal & lt);
        if (keep && fits) {
          float mj = v[u][FM], pt;
          if (s_rigid) {
            const float* s = dft + rows[u] * NF * M + sk;
            const float rf = __ldg(s + FRHOFSI * M);
            mj = __ldg(s + FMFSI * M);
            pt = __ldg(s + FPFSI * M) / (rf * rf);
          } else {
            pt = v[u][FP] / (v[u][FRHO] * v[u][FRHO]);
          }
          st[SX * kCap + pos] = v[u][FX];
          st[SY * kCap + pos] = v[u][FY];
          st[SZ * kCap + pos] = v[u][FZ];
          st[SH * kCap + pos] = v[u][FH];
          st[SU * kCap + pos] = v[u][FU];
          st[SV * kCap + pos] = v[u][FV];
          st[SW * kCap + pos] = v[u][FW];
          st[SMJ * kCap + pos] = mj;
          st[SRHO * kCap + pos] = v[u][FRHO];
          st[SPT * kCap + pos] = pt;
          st[SCLS * kCap + pos] = __int_as_float(
              dem * 8 + (s_fluid ? kSrcFluid : 0) + (s_flbd ? kSrcFlbd : 0) +
              (s_rigid ? kSrcRigid : 0));
        }
        if (CONTACT) {
          const unsigned cb = __ballot_sync(kFull, elig && fits);
          if (elig && fits) clist[cn + __popc(cb & lt)] = pos;
          cn += __popc(cb);
        }
        n += __popc(bal & fitl);
        if (fitl != step_lanes) return e + u * E + __popc(fitl) / M;
      }
    }
    return O;
  };

  // 3. the force sums, window by window (the partial sums carried)
  float au = 0.f, av = 0.f, aw = 0.f, vu = 0.f, vv = 0.f, vw = 0.f;
  float fx = 0.f, fy = 0.f, fz = 0.f;
  int n = 0, cn = 0, e = 0;
  bool whole = false;                        // one window held the stencil
  do {
    __syncwarp();                            // the last window is read
    whole = e == 0;
    e = stage(e, n, cn);
    whole = whole && e == O;
    __syncwarp();
    // this thread's query, loaded after the staging (not live across it)
    const int ql = fact ? qlist[fi] : 0;
    const float* qq = q + ql;
    const float qx = __ldg(qq + FX * M), qy = __ldg(qq + FY * M),
                qz = __ldg(qq + FZ * M), qh = __ldg(qq + FH * M);
    const Flags qd = decode(__ldg(qq + FFLAGS * M));
    const bool dest_fluid = fact && qd.fluid == 1.0f;
    const bool dest_rigid = fact && FSI && qd.rigid == 1.0f;
    // 32 of this thread's candidates at a time: the range tests, then the
    // bodies of the pairs that pass, in candidate order (the warp runs as
    // many bodies as its busiest lane, not one for each candidate)
    for (int c0 = fp; fact && c0 < n; c0 += 32 * P) {
      unsigned hits = 0u;
      for (int k = 0; k < 32; ++k) {
        const int c = c0 + k * P;
        if (c >= n) break;
        const float xij = qx - st[SX * kCap + c];
        const float yij = qy - st[SY * kCap + c];
        const float zij = qz - st[SZ * kCap + c];
        const float r2 = xij * xij + yij * yij + zij * zij;
        if (!(r2 <= r2max)) continue;
        const int cls = __float_as_int(st[SCLS * kCap + c]);
        if ((dest_fluid && (cls & (kSrcFlbd | kSrcRigid))) ||
            (dest_rigid && (cls & kSrcFluid)))
          hits |= 1u << k;
      }
      if (hits == 0u) continue;
      const float qu = __ldg(qq + FU * M), qv = __ldg(qq + FV * M),
                  qw = __ldg(qq + FW * M);
      const float rhoi = __ldg(qq + FRHO * M);
      const float pi_term = __ldg(qq + FP * M) / (rhoi * rhoi);
      float mfsi_i = 0.f, pfsi_term = 0.f;
      if (FSI) {
        const float rhofsi_i = __ldg(qq + FRHOFSI * M);
        mfsi_i = __ldg(qq + FMFSI * M);
        pfsi_term =
            __ldg(qq + FPFSI * M) / fmaxf(rhofsi_i * rhofsi_i, 1e-30f);
      }
      for (; hits; hits &= hits - 1u) {
        const int c = c0 + (__ffs(hits) - 1) * P;
        const float xij = qx - st[SX * kCap + c];
        const float yij = qy - st[SY * kCap + c];
        const float zij = qz - st[SZ * kCap + c];
        const float r2 = xij * xij + yij * yij + zij * zij;
        const float rij = sqrtf(r2);
        const bool src_fluid =
            __float_as_int(st[SCLS * kCap + c]) & kSrcFluid;
        const float hij = 0.5f * (qh + st[SH * kCap + c]);
        const float dw = quintic_gradw<KDIM2>(rij, hij, sig_num, sig_den);
        const float dwx = dw * xij, dwy = dw * yij, dwz = dw * zij;
        const float mj = st[SMJ * kCap + c];   // m_fsi for FSI-rigid
        const float pt = st[SPT * kCap + c];   // p / rho^2 of the class
        if (dest_fluid) {
          const float pij = pi_term + pt;
          const float t = -mj * pij;
          au += t * dwx;
          av += t * dwy;
          aw += t * dwz;
          if (VISC && src_fluid) {
            const float vdotx = (qu - st[SU * kCap + c]) * xij +
                                (qv - st[SV * kCap + c]) * yij +
                                (qw - st[SW * kCap + c]) * zij;
            if (vdotx < 0.0f) {
              const float eps = 0.01f * hij * hij;
              const float muij = hij * vdotx / (r2 + eps);
              const float piij = alpha_c0 * muij * mj *
                                 (2.0f / (rhoi + st[SRHO * kCap + c]));
              vu += -piij * dwx;
              vv += -piij * dwy;
              vw += -piij * dwz;
            }
          }
        }
        if (dest_rigid && src_fluid) {
          const float fac = -mfsi_i * mj * (pt + pfsi_term);
          fx += fac * dwx;
          fy += fac * dwy;
          fz += fac * dwz;
        }
      }
    }
  } while (e < O);

  // the P partial sums of each query, by a tree of fixed shape
  float r[9] = {au, av, aw, vu, vv, vw, fx, fy, fz};
  for (int off = 1; off < P; off <<= 1) {
#pragma unroll
    for (int m = 0; m < 9; ++m) {
      const float o = __shfl_down_sync(kFull, r[m], off);
      if ((fp & (2 * off - 1)) == 0 && fp + off < P) r[m] += o;
    }
  }
  if (fact && fp == 0) {
    float* of = obuf + qlist[fi] * W + F0;
    of[0] = r[0] + r[3];
    of[1] = r[1] + r[4];
    of[2] = r[2] + r[5];
    of[3] = r[6];
    of[4] = r[7];
    of[5] = r[8];
  }

  // 4. the contact sums, a thread a (rigid lane cl, entity slot cs) in
  // groups of 32, over the last window's contact list when one window
  // held the stencil, else over the windows staged again
  const int npair = CONTACT ? nr * S : 0;
  for (int g = 0; g * 32 < npair; ++g) {
    int cs = -1, cl = 0;
    if (g * 32 + lane < npair) {
      const int k = g * 32 + lane, i = k / S;
      cl = rlist[i];
      cs = k - i * S;
      if ((float)cs == decode(__ldg(q + FFLAGS * M + cl)).dem) cs = -1;
    }
    mofidi::Acc acc;
    acc.init();
    e = 0;
    do {
      if (!whole) {
        __syncwarp();
        e = stage(e, n, cn);
        __syncwarp();
      } else {
        e = O;
      }
      if (cs >= 0) {
        const float* cq = q + cl;
        const float cqx = __ldg(cq + FX * M), cqy = __ldg(cq + FY * M),
                    cqz = __ldg(cq + FZ * M), cqh = __ldg(cq + FH * M);
        const float cqvol = __ldg(cq + FM * M) / __ldg(cq + FRHO * M);
        for (int c = 0; c < cn; ++c) {
          const int k = clist[c];
          if ((__float_as_int(st[SCLS * kCap + k]) >> 3) != cs) continue;
          const float sx = st[SX * kCap + k], sy = st[SY * kCap + k],
                      sz = st[SZ * kCap + k];
          const float xij = cqx - sx;
          const float yij = cqy - sy;
          const float zij = cqz - sz;
          float r2 = xij * xij + yij * yij;
          r2 = r2 + zij * zij;
          if (!(r2 <= r2max)) continue;      // r <= cutoff
          const float rij = sqrtf(r2);
          const float hij = 0.5f * (cqh + st[SH * kCap + k]);
          const float wij =
              mofidi::quintic_w<KDIM2>(rij, hij, sig_num, sig_den);
          acc.add<false>(xij, yij, zij, rij, wij, cqvol, sx, sy, sz,
                         st[SU * kCap + k], st[SV * kCap + k],
                         st[SW * kCap + k]);
        }
      }
    } while (e < O);
    if (cs >= 0) acc.store(obuf + cl * W + cs, S, init_dist);
  }

  __syncwarp();
  // 5. the slot's block, contiguous
  if (vec) {
    float4* o4 = reinterpret_cast<float4*>(orow);
    const float4* b4 = reinterpret_cast<const float4*>(obuf);
    for (int i = lane; i < M * W / 4; i += 32) o4[i] = b4[i];
  } else {
    for (int i = lane; i < M * W; i += 32) orow[i] = obuf[i];
  }
}

inline unsigned blocks_for(long long lanes) {
  return (unsigned)((lanes + kThreads - 1) / kThreads);
}

template <int MODE>
int rates_wall_entry(const void* dft, const void* nbr, void* out, int NC,
                     int O, int M, int kdim2, int edac, int has_rigid,
                     float cutoff, float nu2, float cs2, float gx, float gy,
                     float gz, float sig_num, float sig_den, void* stream) {
  if (NC < 0 || O < 1 || M < 1) return (int)cudaErrorInvalidValue;
  if (NC == 0) return 0;
  const auto* d = (const float*)dft;
  const auto* nb = (const long long*)nbr;
  auto* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned nblk = blocks_for((long long)NC * M);
  const int sel = (kdim2 ? 4 : 0) + (edac ? 2 : 0) + (has_rigid ? 1 : 0);
#define RW(K, E, H)                                                        \
  rates_wall_kernel<K, E, H, MODE><<<nblk, kThreads, 0, st>>>(             \
      d, nb, o, NC, O, M, cutoff, nu2, cs2, gx, gy, gz, sig_num, sig_den)
  switch (sel) {
    case 0: RW(false, false, false); break;
    case 1: RW(false, false, true); break;
    case 2: RW(false, true, false); break;
    case 3: RW(false, true, true); break;
    case 4: RW(true, false, false); break;
    case 5: RW(true, false, true); break;
    case 6: RW(true, true, false); break;
    default: RW(true, true, true); break;
  }
#undef RW
  return (int)cudaGetLastError();
}

// the largest r^2 whose sqrtf is <= cutoff: sqrtf rounds correctly, so it
// is monotone, and r = sqrtf(r2) <= cutoff exactly when r2 <= this
inline float r2_limit(float cutoff) {
  float t = cutoff * cutoff;
  if (!(t < INFINITY)) return t;
  while (sqrtf(nextafterf(t, INFINITY)) <= cutoff)
    t = nextafterf(t, INFINITY);
  while (t > 0.0f && sqrtf(t) > cutoff) t = nextafterf(t, 0.0f);
  return t;
}

// the dynamic shared memory of a forces block (bytes) and its warps: kWarps
// unless the output block is so wide that fewer fit; 0 if none fits
inline int forces_block_bytes(int M, int W, int& warps) {
  const long long warp_bytes = 4LL * forces_warp_words(M, W);
  for (warps = kWarps; warps > 0; --warps)
    if (warps * warp_bytes <= kMaxSmem) return (int)(warps * warp_bytes);
  return 0;
}

template <bool KDIM2, bool VISC, bool FSI, bool CONTACT>
int launch_forces(const float* dft, const long long* nbr, float* out, int NC,
                  int O, int M, int S, float cutoff, float alpha_c0,
                  float init_dist, float sig_num, float sig_den,
                  cudaStream_t st) {
  int warps;
  const int bytes = forces_block_bytes(M, CONTACT ? 12 * S + 6 : 6, warps);
  if (bytes == 0) return (int)cudaErrorInvalidValue;
  auto kern = forces_kernel<KDIM2, VISC, FSI, CONTACT>;
  static int opted = 48 * 1024;   // the dynamic shared memory allowed so far
  if (bytes > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    opted = bytes;
  }
  kern<<<(unsigned)((NC + warps - 1) / warps), warps * 32, bytes, st>>>(
      dft, nbr, out, NC, O, M, S, r2_limit(cutoff), alpha_c0, init_dist,
      sig_num, sig_den);
  return (int)cudaGetLastError();
}

// runtime flags -> the template instance
template <bool FSI, bool CONTACT>
int forces_entry(const void* dft, const void* nbr, void* out, int NC, int O,
                 int M, int S, int kdim2, int visc, float cutoff,
                 float alpha_c0, float init_dist, float sig_num,
                 float sig_den, void* stream) {
  // a slot's lanes are one warp's
  if (NC < 0 || O < 1 || M < 1 || M > 32 || (CONTACT && S < 1))
    return (int)cudaErrorInvalidValue;
  if (NC == 0) return 0;
  const auto* d = (const float*)dft;
  const auto* nb = (const long long*)nbr;
  auto* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
#define FC(K, V)                                                         \
  launch_forces<K, V, FSI, CONTACT>(d, nb, o, NC, O, M, S, cutoff,      \
                                    alpha_c0, init_dist, sig_num,       \
                                    sig_den, st)
  switch ((kdim2 ? 2 : 0) + (visc ? 1 : 0)) {
    case 0: return FC(false, false);
    case 1: return FC(false, true);
    case 2: return FC(true, false);
    default: return FC(true, true);
  }
#undef FC
}

}  // namespace

extern "C" int fluid_rates_wall(const void* dft, const void* nbr, void* out,
                                int NC, int O, int M, int kdim2, int edac,
                                int has_rigid, float cutoff, float nu2,
                                float cs2, float gx, float gy, float gz,
                                float sig_num, float sig_den, void* stream) {
  return rates_wall_entry<kRatesWall>(dft, nbr, out, NC, O, M, kdim2, edac,
                                      has_rigid, cutoff, nu2, cs2, gx, gy, gz,
                                      sig_num, sig_den, stream);
}

extern "C" int fluid_rates(const void* dft, const void* nbr, void* out,
                           int NC, int O, int M, int kdim2, int edac,
                           int has_rigid, float cutoff, float nu2, float cs2,
                           float sig_num, float sig_den, void* stream) {
  return rates_wall_entry<kRates>(dft, nbr, out, NC, O, M, kdim2, edac,
                                  has_rigid, cutoff, nu2, cs2, 0.0f, 0.0f,
                                  0.0f, sig_num, sig_den, stream);
}

// the wall sums do not depend on EDAC or the rigid source class: one
// instance per kernel dimension
extern "C" int wall_bc(const void* dft, const void* nbr, void* out, int NC,
                       int O, int M, int kdim2, float cutoff, float gx,
                       float gy, float gz, float sig_num, float sig_den,
                       void* stream) {
  if (NC < 0 || O < 1 || M < 1) return (int)cudaErrorInvalidValue;
  if (NC == 0) return 0;
  const auto* d = (const float*)dft;
  const auto* nb = (const long long*)nbr;
  auto* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned nblk = blocks_for((long long)NC * M);
  if (kdim2)
    rates_wall_kernel<true, false, false, kWall><<<nblk, kThreads, 0, st>>>(
        d, nb, o, NC, O, M, cutoff, 0.0f, 0.0f, gx, gy, gz, sig_num,
        sig_den);
  else
    rates_wall_kernel<false, false, false, kWall><<<nblk, kThreads, 0, st>>>(
        d, nb, o, NC, O, M, cutoff, 0.0f, 0.0f, gx, gy, gz, sig_num,
        sig_den);
  return (int)cudaGetLastError();
}

extern "C" int fluid_forces(const void* dft, const void* nbr, void* out,
                            int NC, int O, int M, int kdim2, int visc,
                            int has_rigid, float cutoff, float alpha_c0,
                            float sig_num, float sig_den, void* stream) {
  if (has_rigid)
    return forces_entry<true, false>(dft, nbr, out, NC, O, M, 0, kdim2, visc,
                                     cutoff, alpha_c0, 0.0f, sig_num, sig_den,
                                     stream);
  return forces_entry<false, false>(dft, nbr, out, NC, O, M, 0, kdim2, visc,
                                    cutoff, alpha_c0, 0.0f, sig_num, sig_den,
                                    stream);
}

extern "C" int fluid_forces_contact(const void* dft, const void* nbr,
                                    void* out, int NC, int O, int M, int S,
                                    int kdim2, int visc, float cutoff,
                                    float alpha_c0, float init_dist,
                                    float sig_num, float sig_den,
                                    void* stream) {
  return forces_entry<true, true>(dft, nbr, out, NC, O, M, S, kdim2, visc,
                                  cutoff, alpha_c0, init_dist, sig_num,
                                  sig_den, stream);
}

// the dynamic shared memory (bytes) a block of fluid_forces (W = 6) or
// fluid_forces_contact (W = 12 S + 6) takes at M lanes a slot
extern "C" int fluid_forces_smem(int M, int W) {
  int warps;
  return forces_block_bytes(M, W, warps);
}
