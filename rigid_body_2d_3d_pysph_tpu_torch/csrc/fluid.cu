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
//                         -> [NC, M, 6] au, av, aw, fx, fy, fz, and the
//                         Mofidi contact columns in K2's order by query
//                         row or by particle (see forces_kernel)
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
// about a third of them in range.  Both templates (rates_wall_kernel for
// B4, B6a, B6b; forces_kernel for B5, B6c) run one warp a query slot (M <=
// 32; wider slots below): the slot's query lanes are listed by a ballot
// (a slot with none writes its rows and stops), the candidates the
// listed queries can sum are staged in shared memory in stencil order by
// one shared stencil walk (StencilWalk), each query's candidates are
// split among the warp's threads (range tests into a hit mask, then the
// pair bodies of the hits only), the partial sums are added by a shuffle
// tree of fixed shape, and the slot's block is written whole from shared
// memory.  A one-lane scan
// (a thread a query lane over every candidate lane) ran each pair body for
// the whole warp whenever one of its lanes had a pair in range, and left
// the sentinel lanes' threads idle.  The compile-time choices of the TPU
// kernels (EDAC, rigid bodies present, artificial viscosity on, the
// kernel's dimension, the columns written) are template parameters, not
// branches per pair.
//
// Slots wider than a warp.  The classic grid (one slot a cell,
// ops/cellpairs.py) sizes its slots from occupancy: the kdk and reference
// orderings run B6a, B6b and B6c on slots of up to kMaxLanes = 256 lanes
// (the 2D coupling grid's 48, the 3D one's 176).  Their instances (WM)
// give a slot of M > 32 lanes ceil(M / 32) warps, each owning 32 query
// lanes over the same stencil walk (WideWalk: a step is one 32-lane piece
// of an entry, so candidates are staged in stencil lane order, in windows
// of kCap that may end inside an entry), so a query lane's sums keep the
// order and shape they have at M <= 32; each warp stages the stencil
// itself.  B4 and B5 take the same instances past 32 lanes (the kdkf step
// and its compact store on a spill grid of more lanes, and the slab kdkf
// step on a classic base).  B5's contact part runs per warp: the warp's
// rigid lanes over its own staged contact list, which holds every lane of
// the stencil in stencil lane order, so a lane's sums and its pick (the
// lowest lane wins a distance tie) are the one-lane kernel's; each warp
// writes the contact rows of its own 32 query lanes (with query rows, a
// warp finds its slot's row by the binary search even without a rigid
// lane of its own, so every lane of a culled slot gets its init row).
//
// The pair bodies evaluate the library's SPH kernel (csrc/sph_kernels.cuh:
// sph::w, sph::gradw, sph::w_gradw; one library per kernel, picked by
// -DRB_SPH_KERNEL at compile time).  Built with --fmad=false, so every
// per-pair term rounds as the plain PyTorch version's does: the contact
// picks are bit for bit the plain version's, the sums differ only in
// summation order.
#include <cmath>
#include <type_traits>

#include "mofidi.cuh"

namespace {

enum {
  FX, FY, FZ, FU, FV, FW, FM, FRHO, FH, FP, FMFSI, FRHOFSI, FPFSI, FFLAGS,
  NF
};

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

// ---------------------------------------------------------------------------
// What the two templates share: one warp a query slot, the candidates
// staged in shared memory in stencil order by StencilWalk, the slot's
// block assembled in shared memory and written whole.
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;         // query slots a block, one warp each
constexpr int kCap = 160;         // staged candidates a window
constexpr int kUnroll = 2;        // stencil steps whose loads are in flight
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxLanes = 256;    // the widest slot of the split passes
constexpr unsigned kFull = 0xffffffffu;
// staged fields (rows of kCap words) and the class bits of a candidate
// (its dem above them)
enum { SX, SY, SZ, SH, SU, SV, SW, SMJ, SRHO, SPT, SCLS, NS };
enum { kSrcFluid = 1, kSrcFlbd = 2, kSrcRigid = 4 };
// the pack fields staging loads for every lane of an entry
constexpr int kLoads = 11;        // x y z u v w m rho h p flags

constexpr int kDems = 64;         // B5: dems a round of the contact sums

// a warp's shared memory in words: staging, a candidate list of kCap
// words (the forces template's contact list), the query and rigid lane
// lists (32 each), the output block [M, W]; with S > 0 entity slots (B5)
// the block at its widest (32 lanes of 6 words), each lane's contact row
// (32 long longs), a list of kDems dems and a bitmap of the dems with
// contact candidates, all at offsets the compiler knows
__host__ __device__ constexpr int warp_words(int M, int W, bool clist,
                                             int S = 0) {
  return NS * kCap + (clist ? kCap : 0) + 64 +
         (S > 0 ? ((32 * 6 + 64 + kDems + (S + 31) / 32 + 3) & ~3)
                : (((M < 32 ? M : 32) * W + 3) & ~3));
}

// the dynamic shared memory of a block (bytes) and its warps: kWarps
// unless a warp's share is so large that fewer fit; 0 if none fits
inline int block_bytes(int M, int W, bool clist, int& warps, int S = 0) {
  const long long warp_bytes = 4LL * warp_words(M, W, clist, S);
  for (warps = kWarps; warps > 0; --warps)
    if (warps * warp_bytes <= kMaxSmem) return (int)(warps * warp_bytes);
  return 0;
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

// zeros over a slot's block o of n words, the warp's lanes striding (16
// bytes a store when by4)
__device__ __forceinline__ void fill_zero(float* o, int n, bool by4,
                                          int lane) {
  if (by4) {
    for (int i = lane; i < n / 4; i += 32)
      reinterpret_cast<float4*>(o)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i = lane; i < n; i += 32) o[i] = 0.0f;
  }
}

// the slot's block b of n words to o, contiguous (16 bytes a store when
// by4)
__device__ __forceinline__ void copy_block(float* o, const float* b, int n,
                                           bool by4, int lane) {
  if (by4) {
    float4* o4 = reinterpret_cast<float4*>(o);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    for (int i = lane; i < n / 4; i += 32) o4[i] = b4[i];
  } else {
    for (int i = lane; i < n; i += 32) o[i] = b[i];
  }
}

// The walk of one slot's stencil row by its warp.  A step covers E = 32 /
// M entries (lane j loads lane sk of entry e + sj), kUnroll steps' loads
// in flight; the row's indices are held 32 entries at a time, entry
// nb_base + j in lane j (the first batch is loaded at construction, beside
// the caller's query flags: one wait for both).  stage() fills a window:
// from entry e on, every lane's kLoads fields are loaded, keep(fl) gives
// the candidate's code (flags word fl, an exact integer; not 0: staged),
// and put(v, row, fl, code, pos, fits) is called on every lane of the warp
// (it may run warp collectives) to store a kept candidate at pos.  Whole
// entries go in, in stencil order, while the window has room; it returns
// the first entry not staged (O: the stencil's end) and the count in n.
// Missing stencil entries cost nothing past their index; sentinel lanes
// go no further than their flags.
struct StencilWalk {
  const float* dft;
  const long long* nb;
  int NC, O, M, E, sj, sk, nb_base;
  bool in_step;
  unsigned step_lanes, upto, lt;
  long long nb_lane;

  __device__ __forceinline__ StencilWalk(const float* dft_,
                                         const long long* nb_, int NC_,
                                         int O_, int M_, int lane)
      : dft(dft_), nb(nb_), NC(NC_), O(O_), M(M_), nb_base(0) {
    E = 32 / M;
    sj = lane / M;
    sk = lane - sj * M;
    in_step = sj < E;
    step_lanes = E * M == 32 ? kFull : (1u << (E * M)) - 1u;
    upto = !in_step ? step_lanes
           : (sj + 1) * M == 32 ? kFull
                                : (1u << ((sj + 1) * M)) - 1u;
    lt = (1u << lane) - 1u;
    nb_lane = lane < O ? nb[lane] : -1LL;
  }

  template <class Keep, class Put>
  __device__ __forceinline__ int stage(int e, int& n, Keep keep, Put put) {
    const int lane = threadIdx.x & 31;
    n = 0;
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
        const unsigned code = keep(fl);
        const unsigned bal = __ballot_sync(kFull, code != 0u);
        const bool fits = n + __popc(bal & upto) <= kCap;
        const unsigned fitl = __ballot_sync(kFull, in_step && fits);
        put(v[u], rows[u], fl, code, n + __popc(bal & lt), fits);
        n += __popc(bal & fitl);
        if (fitl != step_lanes) return e + u * E + __popc(fitl) / M;
      }
    }
    return O;
  }
};

// The walk of a slot wider than a warp (M > 32 lanes: the classic grid's
// slots, sized from occupancy, ops/cellpairs.py).  A step is one piece of
// 32 lanes of one entry (lane j loads lane 32 p + j of entry e; an entry
// is NP = ceil(M / 32) pieces, the walk's position is e NP + p), kUnroll
// steps' loads in flight, so candidates are staged in stencil lane order
// as StencilWalk stages them.  A window takes whole pieces while it has
// room (a piece of 32 always fits an empty window of kCap), so a window
// may end inside an entry.  stage() has StencilWalk's contract with
// positions for entries: it returns the first piece not staged (end: the
// stencil's end), and sk is the slot lane of the calling thread's piece
// while put() runs.
struct WideWalk {
  const float* dft;
  const long long* nb;
  int NC, M, NP, end, sk;
  unsigned lt;

  __device__ __forceinline__ WideWalk(const float* dft_,
                                      const long long* nb_, int NC_, int O_,
                                      int M_, int lane)
      : dft(dft_), nb(nb_), NC(NC_), M(M_), sk(lane) {
    NP = (M + 31) / 32;
    end = O_ * NP;
    lt = (1u << lane) - 1u;
  }

  template <class Keep, class Put>
  __device__ __forceinline__ int stage(int k, int& n, Keep keep, Put put) {
    const int lane = threadIdx.x & 31;
    n = 0;
    for (; k < end; k += kUnroll) {
      long long rows[kUnroll];
      int sks[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kk = k + u, e = kk / NP;
        sks[u] = (kk - e * NP) * 32 + lane;
        rows[u] = kk < end && sks[u] < M ? __ldg(nb + e) : -1LL;
      }
      float v[kUnroll][kLoads];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool ok = rows[u] >= 0 && rows[u] < NC;
        const float* s = dft + (ok ? rows[u] : 0LL) * NF * M + sks[u];
#pragma unroll
        for (int f = 0; f < kLoads; ++f)
          v[u][f] = ok ? __ldg(s + (f < kLoads - 1 ? f : FFLAGS) * M) : 0.f;
        if (!ok) v[u][kLoads - 1] = -16.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (k + u >= end) return end;
        const int fl = (int)v[u][kLoads - 1];
        const unsigned code = keep(fl);
        const unsigned bal = __ballot_sync(kFull, code != 0u);
        if (n + __popc(bal) > kCap) return k + u;   // warp-uniform
        sk = sks[u];
        put(v[u], rows[u], fl, code, n + __popc(bal & lt), true);
        n += __popc(bal);
      }
    }
    return end;
  }
};

// ---------------------------------------------------------------------------
// B4: rates (fluid queries) and the Adami wall sums (wall and body queries)
// in one sweep; B6a the rates alone, B6b the wall sums alone.
//
// One warp a query slot (kWarps slots a block):
// 1. The query ballot: the lanes a sum of this instance runs for (fluid
//    for the rates; static boundary or rigid for the wall sums) are
//    listed; a slot with none writes its zero rows and stops (every
//    sentinel slot, and most of B6b's slots).
// 2. Staging (StencilWalk): the candidates some listed query sums, as
//    structure of arrays: x y z h u v w, the source class's m, rho and p
//    (m_fsi, rho_fsi, p_fsi for an FSI-rigid source), and the class bits.
//    The rates' sources are fluid and static boundary, and FSI-rigid with
//    HAS_RIGID; the wall sums' are fluid, which is never rigid, so one
//    staged (m, rho, p) serves both sums.  A stencil with more than kCap
//    candidates is staged and summed in windows of whole entries, carried
//    in order.
// 3. Thread (i, p) takes listed query i and the staged candidates p, p +
//    P, ... (P = 32 / q), 32 at a time: first the exact r^2 <= r2max test
//    and the query's classes into a hit mask, then the bodies of the hits
//    only, each with the one-lane kernel's arithmetic (pallas_fluid.py
//    :315-352, :389-448, :468-482).
// 4. The P partial sums of a query are added by a shuffle tree of fixed
//    shape (two launches give the same bits).  B6a with bodies keeps the
//    FSI-rigid class's sums apart to the end and adds them last
//    (pallas_fluid.py:348-351); B4 keeps one term per sum (:423-433).
// 5. The slot's [M, W] block, zeros on every lane not listed, is written
//    contiguously from shared memory (16-byte stores where M W allows).
// ---------------------------------------------------------------------------

// which columns a rates/wall instance writes
enum { kRatesWall = 0, kRates = 1, kWall = 2 };

template <int MODE>
__host__ __device__ constexpr int rates_wall_width() {
  return MODE == kRatesWall ? 7 : (MODE == kRates ? 2 : 5);
}

template <bool KDIM2, bool EDAC, bool HAS_RIGID, int MODE, bool WM>
__global__ void __launch_bounds__(kWarps * 32, 6)
    rates_wall_kernel(const float* __restrict__ dft,
                      const long long* __restrict__ nbr,
                      float* __restrict__ out, int NC, int O, int M,
                      float r2max, float nu2, float cs2, float gx, float gy,
                      float gz, float sig_num, float sig_den) {
  constexpr bool RATES = MODE != kWall, WALL = MODE != kRates;
  constexpr bool SPLIT = MODE == kRates && HAS_RIGID;
  constexpr int W = rates_wall_width<MODE>();
  // running sums: arho ap (and the FSI class's arho ap with SPLIT), then
  // uf vf wf sw p_num
  constexpr int NR = RATES ? (SPLIT ? 4 : 2) : 0;
  constexpr int NA = NR + (WALL ? 5 : 0);
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const long long wid =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  // WM: query lanes [qb, qb + MQ) of the slot, 32 a warp
  const int NPQ = WM ? (M + 31) / 32 : 1;
  const long long slot = WM ? wid / NPQ : wid;
  if (slot >= NC) return;                    // the whole warp
  const int qb = WM ? (int)(wid - slot * NPQ) * 32 : 0;
  const int MQ = WM ? min(32, M - qb) : M;
  float* st = reinterpret_cast<float*>(smem4) +
              (threadIdx.x >> 5) * warp_words(M, W, false);
  int* qlist = reinterpret_cast<int*>(st + NS * kCap);
  float* obuf = st + NS * kCap + 64;
  float* orow = out + (slot * M + qb) * W;
  const float* q = dft + slot * NF * M + qb;
  const bool vec = (MQ * W) % 4 == 0 && (WM ? (M * W) % 4 == 0 : true) &&
                   (reinterpret_cast<unsigned long long>(out) & 15ull) == 0;
  using Walk = typename std::conditional<WM, WideWalk, StencilWalk>::type;
  Walk walk(dft, nbr + slot * O, NC, O, M, lane);
  const int wend = WM ? O * NPQ : O;         // the walk's end

  // 1. the query ballot
  Flags qf{-1.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (lane < MQ) qf = decode(__ldg(q + FFLAGS * M + lane));
  const bool q_rates = RATES && qf.fluid == 1.0f;
  const bool q_wall = WALL && (qf.sbdry == 1.0f || qf.rigid == 1.0f);
  const unsigned amask = __ballot_sync(kFull, q_rates || q_wall);
  if (amask == 0u) {
    fill_zero(orow, MQ * W, vec, lane);
    return;
  }
  const bool any_rates = __any_sync(kFull, q_rates);
  const bool any_wall = __any_sync(kFull, q_wall);
  const int nq = __popc(amask);
  if (q_rates || q_wall) qlist[__popc(amask & walk.lt)] = lane;
  fill_zero(obuf, MQ * W, (MQ * W) % 4 == 0, lane);
  __syncwarp();

  // thread (qi, qp): query qi, candidates qp, qp + P, ...
  const int P = 32 / nq;
  const int qi = lane / P, qp = lane - qi * P;
  const bool qact = qi < nq;

  // 2. staging: what some listed query sums
  auto keep = [&](int fl) -> unsigned {
    const bool s_fluid = fl & 2;
    const bool s_rates = s_fluid || (fl & 4) || (HAS_RIGID && (fl & 1));
    return (any_rates && s_rates) || (any_wall && s_fluid);
  };
  auto put = [&](const float* v, long long row, int fl, unsigned code,
                 int pos, bool fits) {
    if (!(code && fits)) return;
    const bool s_fluid = fl & 2;
    const bool s_flbd = s_fluid || (fl & 4);
    const bool s_rigid = HAS_RIGID && (fl & 1);
    float mj = v[FM], rhoj = v[FRHO], pj = v[FP];
    if (s_rigid) {
      const float* s = dft + row * NF * M + walk.sk;
      mj = __ldg(s + FMFSI * M);
      rhoj = __ldg(s + FRHOFSI * M);
      pj = __ldg(s + FPFSI * M);
    }
    st[SX * kCap + pos] = v[FX];
    st[SY * kCap + pos] = v[FY];
    st[SZ * kCap + pos] = v[FZ];
    st[SH * kCap + pos] = v[FH];
    st[SU * kCap + pos] = v[FU];
    st[SV * kCap + pos] = v[FV];
    st[SW * kCap + pos] = v[FW];
    st[SMJ * kCap + pos] = mj;
    st[SRHO * kCap + pos] = rhoj;
    st[SPT * kCap + pos] = pj;
    st[SCLS * kCap + pos] = __int_as_float(
        (s_fluid ? kSrcFluid : 0) + (s_flbd ? kSrcFlbd : 0) +
        (s_rigid ? kSrcRigid : 0));
  };

  // 3. the sums, window by window (the partial sums carried)
  float acc[NA];
#pragma unroll
  for (int m = 0; m < NA; ++m) acc[m] = 0.0f;
  int n = 0, e = 0;
  do {
    __syncwarp();                            // the last window is read
    e = walk.stage(e, n, keep, put);
    __syncwarp();
    // this thread's query, loaded after the staging (not live across it)
    const int ql = qact ? qlist[qi] : 0;
    const float* qq = q + ql;
    const float qx = __ldg(qq + FX * M), qy = __ldg(qq + FY * M),
                qz = __ldg(qq + FZ * M), qh = __ldg(qq + FH * M);
    const Flags qd = decode(__ldg(qq + FFLAGS * M));
    const bool dest_fluid = qact && RATES && qd.fluid == 1.0f;
    const bool dest_solid =
        qact && WALL && (qd.sbdry == 1.0f || qd.rigid == 1.0f);
    const int want = (dest_fluid ? kSrcFlbd | kSrcRigid : 0) |
                     (dest_solid ? kSrcFluid : 0);
    for (int c0 = qp; qact && c0 < n; c0 += 32 * P) {
      unsigned hits = 0u;
      for (int k = 0; k < 32; ++k) {
        const int c = c0 + k * P;
        if (c >= n) break;
        const float xij = qx - st[SX * kCap + c];
        const float yij = qy - st[SY * kCap + c];
        const float zij = qz - st[SZ * kCap + c];
        const float r2 = xij * xij + yij * yij + zij * zij;
        if (!(r2 <= r2max)) continue;
        if (__float_as_int(st[SCLS * kCap + c]) & want) hits |= 1u << k;
      }
      if (!hits) continue;
      float qu = 0.f, qv = 0.f, qw = 0.f, rhoi = 0.f, pi = 0.f, inv_m = 0.f,
            Vi = 0.f;
      if (RATES) {
        qu = __ldg(qq + FU * M);
        qv = __ldg(qq + FV * M);
        qw = __ldg(qq + FW * M);
        rhoi = __ldg(qq + FRHO * M);
        if (EDAC) {
          const float mi = __ldg(qq + FM * M);
          pi = __ldg(qq + FP * M);
          inv_m = 1.0f / fmaxf(mi, 1e-30f);
          Vi = mi / rhoi;
        }
      }
      for (; hits; hits &= hits - 1u) {
        const int c = c0 + (__ffs(hits) - 1) * P;
        const float xij = qx - st[SX * kCap + c];
        const float yij = qy - st[SY * kCap + c];
        const float zij = qz - st[SZ * kCap + c];
        const float r2 = xij * xij + yij * yij + zij * zij;
        const float rij = sqrtf(r2);
        const int cls = __float_as_int(st[SCLS * kCap + c]);
        const float hij = 0.5f * (qh + st[SH * kCap + c]);
        const bool rates = dest_fluid && (cls & (kSrcFlbd | kSrcRigid));
        const bool wall = dest_solid && (cls & kSrcFluid);
        float w = 0.f, dw = 0.f;
        if constexpr (MODE == kRatesWall)
          sph::w_gradw<KDIM2>(rij, hij, sig_num, sig_den, w, dw);
        else if constexpr (RATES)
          dw = sph::gradw<KDIM2>(rij, hij, sig_num, sig_den);
        else
          w = sph::w<KDIM2>(rij, hij, sig_num, sig_den);
        const float mj = st[SMJ * kCap + c];     // m_fsi for FSI-rigid
        const float rhoj = st[SRHO * kCap + c];  // rho_fsi for FSI-rigid
        const float pj = st[SPT * kCap + c];     // p_fsi for FSI-rigid
        if constexpr (RATES) if (rates) {
          const float dwx = dw * xij, dwy = dw * yij, dwz = dw * zij;
          const float vdotdw = (qu - st[SU * kCap + c]) * dwx +
                               (qv - st[SV * kCap + c]) * dwy +
                               (qw - st[SW * kCap + c]) * dwz;
          const float da = rhoi * mj / rhoj * vdotdw;
          float dp = 0.f;
          if (EDAC) {
            const float xdotdw = xij * dwx + yij * dwy + zij * dwz;
            const float eps = 0.01f * hij * hij;
            const float ap1 = rhoi / rhoj * cs2 * mj * vdotdw;
            const float Vj = mj / rhoj;
            const float etaij = nu2 * (rhoi * rhoj) / (rhoi + rhoj);
            const float tmp = inv_m * (Vi * Vi + Vj * Vj) * etaij * xdotdw /
                              (r2 + eps);
            dp = ap1 + tmp * (pi - pj);
          }
          if constexpr (SPLIT) if (cls & kSrcRigid) {
            acc[2] += da;
            acc[3] += dp;
            continue;                        // a source of one class
          }
          acc[0] += da;
          acc[1] += dp;
        }
        if constexpr (WALL) if (wall) {
          const float gdotx = gx * xij + gy * yij + gz * zij;
          acc[NR] += st[SU * kCap + c] * w;
          acc[NR + 1] += st[SV * kCap + c] * w;
          acc[NR + 2] += st[SW * kCap + c] * w;
          acc[NR + 3] += w;
          acc[NR + 4] += (pj + rhoj * gdotx) * w;
        }
      }
    }
  } while (e < wend);

  // 4. the P partial sums of each query, by a tree of fixed shape
  for (int off = 1; off < P; off <<= 1) {
#pragma unroll
    for (int m = 0; m < NA; ++m) {
      const float o = __shfl_down_sync(kFull, acc[m], off);
      if ((qp & (2 * off - 1)) == 0 && qp + off < P) acc[m] += o;
    }
  }
  if (qact && qp == 0) {
    float* o = obuf + qlist[qi] * W;
    if constexpr (SPLIT) {
      o[0] = acc[0] + acc[2];
      o[1] = acc[1] + acc[3];
    } else if constexpr (RATES) {
      o[0] = acc[0];
      o[1] = acc[1];
    }
    if constexpr (WALL) {
#pragma unroll
      for (int m = 0; m < 5; ++m) o[NR + m] = acc[NR + m];
    }
  }
  __syncwarp();
  // 5. the slot's block, contiguous
  copy_block(orow, obuf, MQ * W, vec, lane);
}

// ---------------------------------------------------------------------------
// B5 / B6c: pressure gradient + artificial viscosity; with FSI (rigid
// bodies present) the FSI source class and the fluid -> rigid force; with
// CONTACT the Mofidi contact columns on the union layout.  B5 is FSI and
// CONTACT, B6c FSI (kdk and reference orderings) or neither.
//
// One warp a query slot (kWarps slots a block), every sum in a fixed
// order:
// 1. The slot's query lanes: the lanes a force sum runs for (fluid, and
//    rigid with FSI) are listed by a ballot; a slot with none writes its
//    rows (zeros, and B5's contact init rows) and stops.
// 2. Staging (StencilWalk): the candidates a sum can use (fluid,
//    boundary, FSI-rigid, contact-eligible) go to shared memory in
//    stencil order, as structure of arrays of what the bodies read: x y z
//    h u v w, the source class's m and p / rho^2 (m_fsi and p_fsi /
//    rho_fsi^2 for an FSI-rigid source, the same rounding as the per-pair
//    division), rho, and the class bits with the dem.  A stencil with
//    more than kCap candidates is staged and summed in windows of whole
//    entries, carried in order.  B5 also lists the candidates that pass
//    the flag part of the contact gate (contact boundary, not fluid, a dem
//    some rigid lane of the slot wants).
// 3. Forces: with q listed queries, thread (i, p) takes query i and the
//    staged candidates p, p + P, p + 2P, ... (P = 32 / q), 32 at a time:
//    first the range tests (r2 <= r2max, the exact image of r <= cutoff,
//    and the classes the query sums), then the bodies of the pairs that
//    passed, each the one-lane kernel's arithmetic, so the warp runs as
//    many bodies as its busiest thread has pairs.  The P partial sums of
//    a query are added by a shuffle tree of fixed shape, and the slot's
//    [M, 6] block is written contiguously from shared memory.
// 4. Contact (B5, a slot with a row the step reads): the init rows; with
//    a rigid lane, a bitmap of S bits marks the dems of the listed
//    candidates (of every window), and one thread a (rigid lane cl, dem
//    cs of the bitmap), kDems dems a round, walks the list, adding its
//    gated pairs (dem cs, r <= cutoff) into a mofidi::Acc in stencil
//    order: the sums and the pick are a sequential walk's, bit for bit the
//    one-lane kernel's.  It runs on the staged window when one window held
//    the stencil, else over the windows staged again.  A dem outside the
//    bitmap has no gated pair with any lane.
//
// What the step reads, and so what B5 writes.  The force columns go to
// out [NC, M, 6] for every slot (the kdkf step unpacks them beside B4's,
// every particle's).  The 12 S contact columns go to cout, in one of two
// layouts:
// * query rows (rows non-null), cout [NI, M, 12 S]: the compact route of
//   the kdkf step (rigid_fluid_coupling culled_lanes ->
//   _compact_contact_tail) reads the rows of the light cull's slots
//   (contact_kernel.cull_rigid_query_slots, run before B5: rows[r] is the
//   r-th slot with a rigid lane, ascending, then NC) and every lane of
//   them: the tail runs contact_force_core on all NI M lanes (an empty
//   lane's result goes to a dropped row) and keeps the 12 S columns of
//   every lane in cl_state.  A slot with a rigid lane finds its row by a
//   binary search of rows; a row of a slot without one (a padding row,
//   rows[r] = NC) holds the init row, written by the warps past NC.
// * particle rows (lane_pid non-null), cout [n, 12 S]: the full route of
//   the kdkf step (_contact_tail) reads every particle's row into the
//   scene's [N, S] slot fields, fluid and wall particles' too (init
//   rows).  Lane l of slot s writes particle lane_pid[s M + l]'s row (a
//   lane without a particle is read by nobody); the warps past NC write
//   zeros over the rows of the particles without a lane (dense_pos >= NC
//   M), which the unpack filled with zeros.
// Every lane with a row gets its init row (zeros, the closest distance
// init_dist) first, the warp's threads taking consecutive 16-byte words
// of the row, and the stores drain while the contact threads run; a
// contact thread writes the epilogue's value over it where its lane has a
// gated pair of its dem.  Every other entry is written once, the gated
// ones twice: the order that writes each once leaves 32-byte sectors
// part-written until the contact stores come, and took longer in K2
// (its header in csrc/contact.cu; PERF.md).  No contact column passes
// through shared memory, so one instance serves every S.
// ---------------------------------------------------------------------------

template <bool KDIM2, bool VISC, bool FSI, bool CONTACT, bool WM>
__global__ void __launch_bounds__(kWarps * 32, CONTACT ? 5 : 6)
    forces_kernel(const float* __restrict__ dft,
                  const long long* __restrict__ nbr, float* __restrict__ out,
                  float* __restrict__ cout,
                  const long long* __restrict__ rows,
                  const long long* __restrict__ lane_pid,
                  const long long* __restrict__ dense_pos, int NC, int O,
                  int M, int S, int NI, int n, float r2max, float alpha_c0,
                  float init_dist, float sig_num, float sig_den) {
  extern __shared__ float4 smem4[];
  constexpr int W = 6;
  const int lane = threadIdx.x & 31;
  const long long wid =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  // WM: query lanes [qb, qb + MQ) of the slot, 32 a warp
  const int NPQ = WM ? (M + 31) / 32 : 1;
  const long long slot = WM ? wid / NPQ : wid;
  if (slot >= NC) {
    // B5's warps past the slots' (one a row or 32 particles, also with
    // WM): the init row of a row whose slot has no rigid lane (a padding
    // row, rows[x] = NC), or zeros over the rows of 32 particles without
    // a lane
    if (CONTACT) {
      const long long x = WM ? wid - (long long)NC * NPQ : slot - NC;
      if (rows) {
        if (x >= NI) return;
        const long long rs = __ldg(rows + x);
        bool rigid = false;
        if (rs >= 0 && rs < NC) {
          for (int l = lane; l < M; l += 32) {   // WM: every piece of 32
            rigid = rigid ||
                    decode(__ldg(dft + (rs * NF + FFLAGS) * M + l)).rigid ==
                        1.0f;
            if (!WM) break;
          }
        }
        if (!__any_sync(kFull, rigid))
          mofidi::fill_init_rows(cout, M, S, init_dist, lane, 32, 1, [&](int l) {
            return (x * M + l) * 12LL * S;
          });
      } else {
        const long long p = x * 32 + lane;
        const bool orphan =
            p < n && __ldg(dense_pos + p) >= (long long)NC * M;
        for (unsigned o = __ballot_sync(kFull, orphan); o; o &= o - 1u)
          fill_zero(cout + (x * 32 + __ffs(o) - 1) * 12LL * S, 12 * S, true,
                    lane);
      }
    }
    return;                                  // the whole warp
  }
  float* st = reinterpret_cast<float*>(smem4) +
              (threadIdx.x >> 5) * warp_words(M, W, true, CONTACT ? S : 0);
  int* clist = reinterpret_cast<int*>(st + NS * kCap);
  int* qlist = clist + kCap;
  int* rlist = qlist + 32;
  float* obuf = st + NS * kCap + kCap + 64;
  // B5: each lane's contact row (words into cout; -1: none), a round's
  // list of kDems dems, the bitmap of the dems with contact candidates
  long long* crow = reinterpret_cast<long long*>(obuf + 32 * W);
  int* dlist = reinterpret_cast<int*>(obuf + 32 * W + 64);
  unsigned* bm = reinterpret_cast<unsigned*>(obuf + 32 * W + 64 + kDems);
  const int bmw = CONTACT ? (S + 31) / 32 : 0;
  const int qb = WM ? (int)(wid - slot * NPQ) * 32 : 0;
  const int MQ = WM ? min(32, M - qb) : M;
  float* orow = out + (slot * M + qb) * W;
  const float* q = dft + slot * NF * M + qb;
  const bool vec = (MQ * W) % 4 == 0 && (WM ? (M * W) % 4 == 0 : true) &&
                   (reinterpret_cast<unsigned long long>(out) & 15ull) == 0;
  using Walk = typename std::conditional<WM, WideWalk, StencilWalk>::type;
  Walk walk(dft, nbr + slot * O, NC, O, M, lane);
  const int wend = WM ? O * NPQ : O;         // the walk's end

  // 1. the query lanes (B5 by particle: and their particles, loaded beside)
  Flags qf{-1.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  long long pid = -1;
  if (lane < MQ) {
    qf = decode(__ldg(q + FFLAGS * M + lane));
    if (CONTACT && lane_pid) pid = __ldg(lane_pid + slot * M + qb + lane);
  }
  const bool act = qf.fluid == 1.0f || (FSI && qf.rigid == 1.0f);
  const bool rig = CONTACT && qf.rigid == 1.0f;
  const unsigned amask = __ballot_sync(kFull, act);
  const unsigned rmask = __ballot_sync(kFull, rig);
  const int nq = __popc(amask), nr = __popc(rmask);
  // B5: this lane's contact row (words into cout; -1: none), into crow
  // (WM: a warp with no rigid lane may hold lanes of a culled slot: it
  // searches too)
  auto contact_row = [&]() -> long long {
    if (!rows) return pid >= 0 && pid < n ? pid * 12LL * S : -1LL;
    if (!WM && nr == 0) return -1LL;         // not a culled slot
    int lo = 0, hi = NI;                     // rows ascend: a binary search
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(rows + mid) < slot) lo = mid + 1;
      else hi = mid;
    }
    return lo < NI && __ldg(rows + lo) == slot && lane < MQ
               ? ((long long)lo * M + qb + lane) * 12LL * S : -1LL;
  };
  // B5: the init rows over the lanes' contact rows (crow), 16 bytes a
  // thread a store
  auto fill_rows = [&]() {
    mofidi::fill_init_rows(cout, MQ, S, init_dist, lane, 32, 1,
                           [&](int l) { return crow[l]; });
  };
  if (CONTACT) {            // the rows now: the slot is not live past here
    crow[lane] = contact_row();
    __syncwarp();
  }
  if (nq == 0) {
    fill_zero(orow, MQ * W, vec, lane);
    if (CONTACT) fill_rows();
    return;
  }
  const unsigned lt = walk.lt;
  if (act) qlist[__popc(amask & lt)] = lane;
  if (rig) rlist[__popc(rmask & lt)] = lane;
  fill_zero(obuf, MQ * W, (MQ * W) % 4 == 0, lane);
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

  // 2. staging: the window of candidates from stencil entry e on, and
  // the contact list (cn entries) of the eligible ones
  // a candidate's code: 1 staged for the force sums, 2 for contact (and
  // listed)
  int cn = 0;
  auto keep = [&](int fl) -> unsigned {
    const int dem = fl >> 4;
    const bool elig = CONTACT && nr > 0 && (fl & 8) && !(fl & 2) &&
                      dem >= 0 && dem < S && dem != skip_dem;
    return ((fl & 2) || (fl & 4) || (FSI && (fl & 1)) ? 1u : 0u) |
           (elig ? 2u : 0u);
  };
  auto put = [&](const float* v, long long row, int fl, unsigned code,
                 int pos, bool fits) {
    if (code && fits) {
      const bool s_fluid = fl & 2;
      const bool s_flbd = s_fluid || (fl & 4);
      const bool s_rigid = FSI && (fl & 1);
      float mj = v[FM], pt;
      if (s_rigid) {
        const float* s = dft + row * NF * M + walk.sk;
        const float rf = __ldg(s + FRHOFSI * M);
        mj = __ldg(s + FMFSI * M);
        pt = __ldg(s + FPFSI * M) / (rf * rf);
      } else {
        pt = v[FP] / (v[FRHO] * v[FRHO]);
      }
      st[SX * kCap + pos] = v[FX];
      st[SY * kCap + pos] = v[FY];
      st[SZ * kCap + pos] = v[FZ];
      st[SH * kCap + pos] = v[FH];
      st[SU * kCap + pos] = v[FU];
      st[SV * kCap + pos] = v[FV];
      st[SW * kCap + pos] = v[FW];
      st[SMJ * kCap + pos] = mj;
      st[SRHO * kCap + pos] = v[FRHO];
      st[SPT * kCap + pos] = pt;
      st[SCLS * kCap + pos] = __int_as_float(
          (fl >> 4) * 8 + (s_fluid ? kSrcFluid : 0) +
          (s_flbd ? kSrcFlbd : 0) + (s_rigid ? kSrcRigid : 0));
    }
    if (CONTACT) {
      const bool el = (code & 2u) && fits;
      const unsigned cb = __ballot_sync(kFull, el);
      if (el) clist[cn + __popc(cb & lt)] = pos;
      cn += __popc(cb);
    }
  };
  auto stage = [&](int e, int& n) -> int {
    cn = 0;
    return walk.stage(e, n, keep, put);
  };

  // 3. the force sums, window by window (the partial sums carried)
  float au = 0.f, av = 0.f, aw = 0.f, vu = 0.f, vv = 0.f, vw = 0.f;
  float fx = 0.f, fy = 0.f, fz = 0.f;
  int ns = 0, e = 0;
  bool whole = false;                        // one window held the stencil
  do {
    __syncwarp();                            // the last window is read
    whole = e == 0;
    e = stage(e, ns);
    whole = whole && e == wend;
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
    for (int c0 = fp; fact && c0 < ns; c0 += 32 * P) {
      unsigned hits = 0u;
      for (int k = 0; k < 32; ++k) {
        const int c = c0 + k * P;
        if (c >= ns) break;
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
        const float dw = sph::gradw<KDIM2>(rij, hij, sig_num, sig_den);
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
  } while (e < wend);

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
    float* of = obuf + qlist[fi] * W;
    of[0] = r[0] + r[3];
    of[1] = r[1] + r[4];
    of[2] = r[2] + r[5];
    of[3] = r[6];
    of[4] = r[7];
    of[5] = r[8];
  }
  __syncwarp();
  copy_block(orow, obuf, MQ * W, vec, lane);
  if (!CONTACT) return;

  // 4. the contact rows: the init rows first (their stores drain while the
  // contact threads run)
  if (!__any_sync(kFull, crow[lane] >= 0)) return;  // no row is read
  fill_rows();
  if (nr == 0) return;                       // no rigid lane: no sum
  // the bitmap of the dems in the contact list, of every window
  for (int i = lane; i < bmw; i += 32) bm[i] = 0u;
  __syncwarp();
  auto mark = [&]() {
    for (int c = lane; c < cn; c += 32) {
      const int dem = __float_as_int(st[SCLS * kCap + clist[c]]) >> 3;
      atomicOr(&bm[dem >> 5], 1u << (dem & 31));
    }
  };
  if (whole) {
    mark();
  } else {
    e = 0;
    do {
      __syncwarp();
      e = stage(e, ns);
      __syncwarp();
      mark();
    } while (e < wend);
  }
  __syncwarp();
  // the contact sums, a thread a (rigid lane cl, dem cs of the bitmap) in
  // groups of 32, kDems dems a round, over the last window's contact list
  // when one window held the stencil, else over the windows staged again
  int nd = 0;                                // the bitmap's dems
  for (int i = lane; i < bmw; i += 32) nd += __popc(bm[i]);
  nd = __reduce_add_sync(kFull, nd);
  for (int kb = 0; kb < nd; kb += kDems) {
    const int nb = min(kDems, nd - kb);
    // dlist: the bitmap's dems kb .. kb + nb - 1, ascending
    int base = 0;
    for (int w0 = 0; w0 < bmw; w0 += 32) {
      const unsigned word = w0 + lane < bmw ? bm[w0 + lane] : 0u;
      const int cnt = __popc(word);
      int incl = cnt;
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += v;
      }
      int rk = base + incl - cnt;
      for (unsigned x = word; x; x &= x - 1u, ++rk)
        if (rk >= kb && rk < kb + nb)
          dlist[rk - kb] = ((w0 + lane) << 5) + __ffs(x) - 1;
      base += __shfl_sync(kFull, incl, 31);
    }
    __syncwarp();
    const int npair = nr * nb;
    for (int g = 0; g * 32 < npair; ++g) {
      int cs = -1, cl = 0;
      bool own = false;   // the lane's own dem: no gated pair, the init
      if (g * 32 + lane < npair) {
        const int k = g * 32 + lane, i = k / nb;
        cl = rlist[i];
        cs = dlist[k - i * nb];
        own = (float)cs == decode(__ldg(q + FFLAGS * M + cl)).dem;
      }
      mofidi::Acc acc;
      acc.init();
      e = 0;
      do {
        if (!whole) {
          __syncwarp();
          e = stage(e, ns);
          __syncwarp();
        } else {
          e = wend;
        }
        if (cs >= 0 && !own) {
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
                sph::w<KDIM2>(rij, hij, sig_num, sig_den);
            acc.add<false>(xij, yij, zij, rij, wij, cqvol, sx, sy, sz,
                           st[SU * kCap + k], st[SV * kCap + k],
                           st[SW * kCap + k]);
          }
        }
      } while (e < wend);
      // the epilogue over the init row where the lane has a gated pair
      if (cs >= 0 && acc.minr < mofidi::kBig && crow[cl] >= 0)
        acc.store(cout + crow[cl] + cs, S, init_dist);
    }
    __syncwarp();                            // dlist is written again
  }
}

// the dynamic shared memory a kernel may take, raised once per instance
template <class K>
int allow_smem(K kern, int bytes, int& opted) {
  if (bytes <= opted) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  opted = bytes;
  return 0;
}

template <bool KDIM2, bool EDAC, bool HAS_RIGID, int MODE, bool WM>
int launch_rates_wall(const float* dft, const long long* nbr, float* out,
                      int NC, int O, int M, float cutoff, float nu2,
                      float cs2, float gx, float gy, float gz, float sig_num,
                      float sig_den, cudaStream_t st) {
  int warps;
  const int bytes = block_bytes(M, rates_wall_width<MODE>(), false, warps);
  if (bytes == 0) return (int)cudaErrorInvalidValue;
  auto kern = rates_wall_kernel<KDIM2, EDAC, HAS_RIGID, MODE, WM>;
  static int opted = 48 * 1024;   // the dynamic shared memory allowed so far
  if (const int err = allow_smem(kern, bytes, opted)) return err;
  // a warp a query slot, or (WM) a warp a 32 lanes of one
  const long long total = (long long)NC * (WM ? (M + 31) / 32 : 1);
  kern<<<(unsigned)((total + warps - 1) / warps), warps * 32, bytes, st>>>(
      dft, nbr, out, NC, O, M, r2_limit(cutoff), nu2, cs2, gx, gy, gz,
      sig_num, sig_den);
  return (int)cudaGetLastError();
}

// runtime flags -> the template instance; the wall sums depend on neither
// EDAC nor the rigid source class (one instance per kernel dimension)
template <int MODE, bool WM>
int rates_wall_dispatch(const float* d, const long long* nb, float* o,
                        int NC, int O, int M, int kdim2, int edac,
                        int has_rigid, float cutoff, float nu2, float cs2,
                        float gx, float gy, float gz, float sig_num,
                        float sig_den, cudaStream_t st) {
#define RW(K, E, H)                                                        \
  launch_rates_wall<K, E, H, MODE, WM>(d, nb, o, NC, O, M, cutoff, nu2,   \
                                       cs2, gx, gy, gz, sig_num, sig_den, \
                                       st)
  if constexpr (MODE == kWall) {
    return kdim2 ? RW(true, false, false) : RW(false, false, false);
  } else {
    switch ((kdim2 ? 4 : 0) + (edac ? 2 : 0) + (has_rigid ? 1 : 0)) {
      case 0: return RW(false, false, false);
      case 1: return RW(false, false, true);
      case 2: return RW(false, true, false);
      case 3: return RW(false, true, true);
      case 4: return RW(true, false, false);
      case 5: return RW(true, false, true);
      case 6: return RW(true, true, false);
      default: return RW(true, true, true);
    }
  }
#undef RW
}

// a slot of M <= 32 lanes is a warp's; a wider one, up to kMaxLanes (the
// classic grid's, or a spill grid of more lanes), ceil(M / 32) warps'
template <int MODE>
int rates_wall_entry(const void* dft, const void* nbr, void* out, int NC,
                     int O, int M, int kdim2, int edac, int has_rigid,
                     float cutoff, float nu2, float cs2, float gx, float gy,
                     float gz, float sig_num, float sig_den, void* stream) {
  if (NC < 0 || O < 1 || M < 1 || M > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  if (NC == 0) return 0;
  const auto* d = (const float*)dft;
  const auto* nb = (const long long*)nbr;
  auto* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  if (M > 32)
    return rates_wall_dispatch<MODE, true>(d, nb, o, NC, O, M, kdim2, edac,
                                           has_rigid, cutoff, nu2, cs2, gx,
                                           gy, gz, sig_num, sig_den, st);
  return rates_wall_dispatch<MODE, false>(d, nb, o, NC, O, M, kdim2, edac,
                                          has_rigid, cutoff, nu2, cs2, gx, gy,
                                          gz, sig_num, sig_den, st);
}

template <bool KDIM2, bool VISC, bool FSI, bool CONTACT, bool WM>
int launch_forces(const float* dft, const long long* nbr, float* out,
                  float* cout, const long long* rows,
                  const long long* lane_pid, const long long* dense_pos,
                  int NC, int O, int M, int S, int NI, int n, float cutoff,
                  float alpha_c0, float init_dist, float sig_num,
                  float sig_den, cudaStream_t st) {
  int warps;
  const int bytes = block_bytes(M, 6, true, warps, CONTACT ? S : 0);
  if (bytes == 0) return (int)cudaErrorInvalidValue;
  auto kern = forces_kernel<KDIM2, VISC, FSI, CONTACT, WM>;
  static int opted = 48 * 1024;   // the dynamic shared memory allowed so far
  if (const int err = allow_smem(kern, bytes, opted)) return err;
  // a warp a query slot (WM: a warp a 32 lanes of one); B5's warps past
  // the slots: the padding rows, or 32 particles each
  const long long total =
      (long long)NC * (WM ? (M + 31) / 32 : 1) +
      (!CONTACT ? 0LL : rows ? (long long)NI : (n + 31LL) / 32);
  kern<<<(unsigned)((total + warps - 1) / warps), warps * 32, bytes, st>>>(
      dft, nbr, out, cout, rows, lane_pid, dense_pos, NC, O, M, S, NI, n,
      r2_limit(cutoff), alpha_c0, init_dist, sig_num, sig_den);
  return (int)cudaGetLastError();
}

// runtime flags -> the template instance
template <bool FSI, bool CONTACT>
int forces_entry(const void* dft, const void* nbr, void* out, void* cout,
                 const void* rows, const void* lane_pid,
                 const void* dense_pos, int NC, int O, int M, int S, int NI,
                 int n, int kdim2, int visc, float cutoff, float alpha_c0,
                 float init_dist, float sig_num, float sig_den,
                 void* stream) {
  // a slot of M <= 32 lanes is a warp's; a wider one, up to kMaxLanes,
  // ceil(M / 32) warps'; B5 writes its contact columns by query row or by
  // particle
  if (NC < 0 || O < 1 || M < 1 || M > kMaxLanes ||
      (CONTACT && (S < 1 || !cout || (rows != nullptr) == (lane_pid != nullptr)
                   || (rows && NI < 0) ||
                   (lane_pid && (!dense_pos || n < 0)))))
    return (int)cudaErrorInvalidValue;
  const auto* d = (const float*)dft;
  const auto* nb = (const long long*)nbr;
  auto* o = (float*)out;
  auto* co = (float*)cout;
  const auto* rw = (const long long*)rows;
  const auto* lp = (const long long*)lane_pid;
  const auto* dp = (const long long*)dense_pos;
  if (NC == 0 && (!CONTACT || (rw ? NI : n) == 0)) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
#define FC(K, V, WM)                                                      \
  launch_forces<K, V, FSI, CONTACT, WM>(d, nb, o, co, rw, lp, dp, NC, O, M, \
                                        S, NI, n, cutoff, alpha_c0,         \
                                        init_dist, sig_num, sig_den, st)
  if (M > 32) {
    switch ((kdim2 ? 2 : 0) + (visc ? 1 : 0)) {
      case 0: return FC(false, false, true);
      case 1: return FC(false, true, true);
      case 2: return FC(true, false, true);
      default: return FC(true, true, true);
    }
  }
  switch ((kdim2 ? 2 : 0) + (visc ? 1 : 0)) {
    case 0: return FC(false, false, false);
    case 1: return FC(false, true, false);
    case 2: return FC(true, false, false);
    default: return FC(true, true, false);
  }
#undef FC
}

}  // namespace

// Each entry point's sph_id is the SPH kernel's id (ops/kernels.py
// Kernel.device_id); it must be the one this library was built for.
extern "C" int fluid_rates_wall(const void* dft, const void* nbr, void* out,
                                int NC, int O, int M, int kdim2, int edac,
                                int has_rigid, int sph_id, float cutoff,
                                float nu2, float cs2, float gx, float gy,
                                float gz, float sig_num, float sig_den,
                                void* stream) {
  if (sph_id != sph::kId) return (int)cudaErrorInvalidValue;
  return rates_wall_entry<kRatesWall>(dft, nbr, out, NC, O, M, kdim2, edac,
                                      has_rigid, cutoff, nu2, cs2, gx, gy, gz,
                                      sig_num, sig_den, stream);
}

extern "C" int fluid_rates(const void* dft, const void* nbr, void* out,
                           int NC, int O, int M, int kdim2, int edac,
                           int has_rigid, int sph_id, float cutoff, float nu2,
                           float cs2, float sig_num, float sig_den,
                           void* stream) {
  if (sph_id != sph::kId) return (int)cudaErrorInvalidValue;
  return rates_wall_entry<kRates>(dft, nbr, out, NC, O, M, kdim2, edac,
                                  has_rigid, cutoff, nu2, cs2, 0.0f, 0.0f,
                                  0.0f, sig_num, sig_den, stream);
}

extern "C" int wall_bc(const void* dft, const void* nbr, void* out, int NC,
                       int O, int M, int kdim2, int sph_id, float cutoff,
                       float gx, float gy, float gz, float sig_num,
                       float sig_den, void* stream) {
  if (sph_id != sph::kId) return (int)cudaErrorInvalidValue;
  return rates_wall_entry<kWall>(dft, nbr, out, NC, O, M, kdim2, 0, 0,
                                 cutoff, 0.0f, 0.0f, gx, gy, gz, sig_num,
                                 sig_den, stream);
}

extern "C" int fluid_forces(const void* dft, const void* nbr, void* out,
                            int NC, int O, int M, int kdim2, int visc,
                            int has_rigid, int sph_id, float cutoff,
                            float alpha_c0, float sig_num, float sig_den,
                            void* stream) {
  if (sph_id != sph::kId) return (int)cudaErrorInvalidValue;
  if (has_rigid)
    return forces_entry<true, false>(dft, nbr, out, nullptr, nullptr,
                                     nullptr, nullptr, NC, O, M, 0, 0, 0,
                                     kdim2, visc, cutoff, alpha_c0, 0.0f,
                                     sig_num, sig_den, stream);
  return forces_entry<false, false>(dft, nbr, out, nullptr, nullptr, nullptr,
                                    nullptr, NC, O, M, 0, 0, 0, kdim2, visc,
                                    cutoff, alpha_c0, 0.0f, sig_num, sig_den,
                                    stream);
}

// out [NC, M, 6]: the force columns.  cout: the 12 S contact columns by
// query row (rows [NI]: the slots, ascending, then NC; cout [NI, M, 12 S])
// or by particle (lane_pid [NC M]: a lane's particle, outside [0, n) none;
// dense_pos [n]: a particle's lane, >= NC M none; cout [n, 12 S]); the
// other pointer is null (ops/fluid_kernel.py fluid_forces_contact)
extern "C" int fluid_forces_contact(const void* dft, const void* nbr,
                                    void* out, void* cout, const void* rows,
                                    const void* lane_pid,
                                    const void* dense_pos, int NC, int O,
                                    int M, int S, int NI, int n, int kdim2,
                                    int visc, int sph_id, float cutoff,
                                    float alpha_c0, float init_dist,
                                    float sig_num, float sig_den,
                                    void* stream) {
  if (sph_id != sph::kId) return (int)cudaErrorInvalidValue;
  return forces_entry<true, true>(dft, nbr, out, cout, rows, lane_pid,
                                  dense_pos, NC, O, M, S, NI, n, kdim2, visc,
                                  cutoff, alpha_c0, init_dist, sig_num,
                                  sig_den, stream);
}

// the dynamic shared memory (bytes) a block of fluid_forces (S = 0) or of
// fluid_forces_contact (S entity slots) takes at M lanes a slot
extern "C" int fluid_forces_smem(int M, int S) {
  int warps;
  return block_bytes(M, 6, true, warps, S);
}

// the dynamic shared memory (bytes) a block of fluid_rates_wall (W = 7),
// fluid_rates (W = 2) or wall_bc (W = 5) takes at M lanes a slot
extern "C" int fluid_rates_wall_smem(int M, int W) {
  int warps;
  return block_bytes(M, W, false, warps);
}
