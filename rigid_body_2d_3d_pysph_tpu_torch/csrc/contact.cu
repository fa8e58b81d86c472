// Mofidi contact sums, closest-source pick and epilogue per query lane.
//
// Replaces the TPU kernel rigid_body_2d_3d_pysph_tpu/ops/pallas_contact.py
// (_kernel + _pair_body, wrapper contact_sums_pallas; the compact
// pipeline contact_pipeline_compact_pallas drives it).  For query row b
// (row qslot[b] of the dense pack) and each source-entity slot s < S it
// computes, over the gated pairs with the stencil's source lanes
// (rows nbr[b][0..O) of the pack, M lanes each, in that order):
//
//   Eq. 22 sums  q0..q2 = sum t1 * (xij, yij, zij),  t1 = V_q W / r
//   Eq. 21 sums  q3 = sum t2,  q4..q6 = sum t2 * (xij, yij, zij),  t2 = t1 r
//   the closest gated source (lowest stencil lane on a distance tie)
//
// and the epilogue of pallas_contact.py:313-328, writing column c * S + s
// of a lane's output row for the 12 column blocks c: cfn x/y/z, wij sum,
// contact distance, closest distance, picked source x/y/z/u/v/w; every
// (lane, s) without a gated pair, and every padding row, holds the init
// row (the output rows: below, "What the step reads").  The gate is: source on the contact boundary, not fluid, of
// another dem entity than the query; rigid query; r <= cutoff.  Pack
// fields: 2D x y u v vol h flags (F = 7), 3D x y z u v w vol h flags
// (F = 9); the flags word is dem*8 + boundary*4 + fluid*2 + rigid (the
// sentinel -8 decodes to dem -1).  qslot [NI] and nbr [NI, O] are int64,
// the grid build's own index type.
//
// Bound on the card: latency and instruction issue, not bytes.  A
// stencil holds O x M lanes (3D: 176 x 16 = 2,816 before the overflow
// rebuilds widen it), half of them sentinels or padding, and of the live
// ones only the contact surface of another dem can pass the gate (a
// quarter of a cube's particles are surface, 4 % of a 2D block's); of
// those, a query lane near a face finds a quarter within the cutoff, so
// the gated pairs are dense in the candidates that remain.  The output,
// 12 S words a lane, is the only large byte stream (80 MB when every slot
// of the 2D stack is a query at S = 9, 1.4 GB at S = 300).
// Design: one block of 128 threads a query row: M query lanes times P =
// 128 / M lane groups, so even the few hundred culled rows of the main
// path fill the card.
// 1. The query lanes and their output rows; the init row over each lane
//    with an output row (16-byte stores); a row with no rigid lane stops
//    here.
// 2. Staging, sorted by dem.  Lane group c walks part c of the stencil
//    (contiguous entries, in order), reading the flags word of every
//    lane, with UNROLL entries' loads in flight: a candidate is a live
//    lane on the contact surface, not fluid, of a dem that some rigid
//    lane of the row wants (a row whose rigid lanes all have one dem drops
//    that dem's sources, which is the interest cull's test).  Sentinel
//    lanes, padding entries and interior particles go no further.  The
//    groups count their candidates per dem, the counts give every
//    (dem, part) its first place, and a second walk places x y z h and
//    the pack lane of each candidate (a cursor per part and dem, ranks
//    among a round's lanes by __match_any_sync): in shared memory a dem's
//    candidates are contiguous and in stencil order.
// 3. For each dem s with candidates, a tile of TT = P x U of them at a
//    time: thread (l, c) runs the pair bodies of query lane l with
//    candidates c U .. c U + U - 1 of the tile (a candidate is tested
//    once per query lane, not once per entity slot, and only for the dems
//    the lane wants): r^2 <= 1.001 cutoff^2 before the square root, then
//    the exact r = sqrt(x*x + y*y + z*z), the gate r <= cutoff, W (the
//    library's SPH kernel, csrc/sph_kernels.cuh) and t1 = V_q W / r into
//    shared memory; then group 0 adds the tile's gated
//    pairs in candidate order into one accumulator a lane (the Eq. 21/22
//    terms from t1, r and the positions) and keeps the pick by a strict
//    "<".  So the sums are a sequential walk's over the stencil, bit for
//    bit the parent kernel's, and the pick is the lowest stencil lane on
//    a tie, exactly as the plain version's.
// 4. At a dem's end, the epilogue (csrc/mofidi.cuh store_row) over the
//    init row for each lane with a gated pair of it, the picked source's
//    fields read from the pack by its lane.
// A stencil with more than CAP candidates is sorted and summed in windows
// of CAP (a second walk per window; group 0 carries a dem's sums across
// them).  Nothing goes through a matrix unit.  Built with
// --fmad=false so r rounds as the plain version's does and the picks,
// distance ties included, agree bit for bit.
//
// Any S: the instance above keeps a row's dems as 64-bit masks and its
// count tables in static shared memory, so it takes S <= S_MAX.  The wide
// instance (WIDE, S > S_MAX) carries the same facts without masks: a
// lane wants every dem but its own if it is rigid, so a lane is (rigid,
// own dem) and the row wants every dem but one (the dem all its rigid
// lanes share) or every dem.  Its count tables (2 P SC + SC + 1 ints) are
// in dynamic shared memory, sized from the SC dems of a chunk: the dems
// are taken SC at a time (one chunk up to WIDE_CHUNK dems), each chunk
// walks the stencil again and sums only its own dems, so a (lane, dem)
// gets the same sums and pick as in one pass.  The match key is c SC + d
// (a dem above 255 would collide in the 8-bit key).  Everything else,
// the pick rules and the order of each dem's sums, is the code above.
//
// What the step reads, and so what is written.  Every lane with an
// output row gets its init row (zeros, the closest distance init_dist) at
// the row's start, each warp a lane row at a time with 16-byte stores
// along the row, and the stores drain while the walks and the sums run;
// the epilogue's value goes over it at the dem's end where the lane has a
// gated pair (group 0, a lane a thread, 12 stores of stride S).  Every
// other entry is written once, the gated ones (a few in a hundred) twice.
// Two orders that write each entry once took longer on the card
// (scripts/contact_variants.py `writeonce`; PERF.md): the init
// values after the windows (no overlap with the walks), and the dems
// without a candidate between the walks with the others at each dem's
// end (their 32-byte sectors part-written until the epilogue's stores
// came).  Two output layouts:
//
// * query rows, out [NI, M, 12 S] (lane_pid null): the culled rows of the
//   rigid GTVF step (contact_pipeline_compact -> _compact_contact_tail,
//   and the slab step's rigid_contact_force_eval_compact_blob).  The tail
//   reads every lane of every row: contact_force_core runs on all NI M
//   lanes, an empty lane's (pid = n) result goes to a dropped row, and
//   the 12 S columns of every lane are kept in cl_state (read back by
//   pid, written out by expand_slot_scene).  So every lane of every row
//   is written; a padding row queries the all-sentinel row (no rigid
//   lane) and holds the init row.
// * particle rows, out [n, 12 S] (lane_pid, dense_pos): every slot of the
//   cell pipeline (contact_pipeline_cell -> _contact_tail: the coupling
//   kdk, reference, no-fluid and RK2 orderings, the rigid RK2, leapfrog
//   and skin steps, the slab steps' full route).  The tail reads every
//   particle's row into the scene's [N, S] slot fields, fluid and wall
//   particles' too (init rows); a lane without a particle is read by
//   nobody and is not written.  Lane l of row b writes particle
//   lane_pid[qslot[b] M + l]'s row, straight into the tail's layout (no
//   unpack); the blocks past NI zero the rows of the particles without a
//   lane (dense_pos >= n_lanes), which the unpack filled with zeros.
#include "mofidi.cuh"

namespace {

constexpr int M = 16;          // lanes a slot (the contact grids' width)
constexpr int THREADS = 128;   // a block: one query row
constexpr int P = THREADS / M; // lane groups: stencil parts
constexpr int CAP_3D = 1536;   // sorted candidates a window: 3D,
constexpr int CAP_2D = 512;    // 2D (a 2D stencil holds ~16 x 16 lanes)
constexpr int UNROLL = 8;      // stencil entries whose loads are in flight
constexpr int S_MAX = 64;      // narrow: a dem is a bit of a 64-bit mask
constexpr int WIDE_CHUNK = 2048;   // wide: the most dems a chunk
constexpr int NO_RIGID = -2;   // wide: the row has no rigid lane
constexpr unsigned FULL = 0xffffffffu;

constexpr int ORPHANS = CAP_2D;   // particles a zeroing block looks at

struct Args {
  const float* dft;              // [nrows, F, M]
  const long long* qslot;        // [NI]
  const long long* nbr;          // [NI, O]
  float* out;                    // [NI, M, 12 S] or [n, 12 S]
  const long long* lane_pid;     // [n_lanes] a pack lane's particle (null:
                                 // query rows)
  const long long* dense_pos;    // [n] a particle's pack lane
  int NI, O, nrows, S;
  int chunk;                     // wide: dems a chunk (the tables' width)
  int n, n_lanes;                // particle rows: particles, mapped lanes
  float cutoff, init_dist, sig_num, sig_den;
};

struct Flags {
  float dem, bdry, fluid, rigid;
};

__device__ __forceinline__ Flags decode(float f) {
  Flags d;
  d.dem = floorf(f * 0.125f);
  float r = f - 8.0f * d.dem;
  d.bdry = floorf(r * 0.25f);
  r = r - 4.0f * d.bdry;
  d.fluid = floorf(r * 0.5f);
  d.rigid = r - 2.0f * d.fluid;
  return d;
}

// the wide instance's dynamic shared memory (bytes) at `chunk` dems
__host__ __device__ constexpr int wide_bytes(int chunk) {
  return 4 * (2 * P * chunk + chunk + 1);
}

// Particle rows: block z of the zeroing blocks writes zeros over the rows
// of the particles [z ORPHANS, (z + 1) ORPHANS) that have no pack lane,
// listed in `list` (ORPHANS ints of shared memory).
__device__ __forceinline__ void zero_orphans(const Args& a, int z,
                                             int* list) {
  __shared__ int s_n;
  const int t = threadIdx.x;
  if (t == 0) s_n = 0;
  __syncthreads();
  for (int i = t; i < ORPHANS; i += THREADS) {
    const long long p = (long long)z * ORPHANS + i;
    if (p < a.n && a.dense_pos[p] >= a.n_lanes) list[atomicAdd(&s_n, 1)] = i;
  }
  __syncthreads();
  const int per = 3 * a.S;      // float4 a row (12 S words, 16-byte aligned)
  for (int j = 0; j < s_n; ++j) {
    float4* o = reinterpret_cast<float4*>(
        a.out + ((long long)z * ORPHANS + list[j]) * 12 * a.S);
    for (int i = t; i < per; i += THREADS)
      o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <bool TWO_D, bool WIDE>
__global__ void __launch_bounds__(THREADS)
    contact_kernel(const Args a) {
  constexpr int F = TWO_D ? 7 : 9;
  constexpr int FX = 0, FY = 1, FZ = 2;
  constexpr int FU = TWO_D ? 2 : 3, FV = TWO_D ? 3 : 4, FW = 5;
  constexpr int FVOL = TWO_D ? 4 : 6, FH = TWO_D ? 5 : 7;
  constexpr int FFLAGS = TWO_D ? 6 : 8;
  constexpr int CAP = TWO_D ? CAP_2D : CAP_3D;
  constexpr int U = 8;               // pair bodies a thread, a tile
  constexpr int TT = P * U;          // candidates a tile
  constexpr int SN = WIDE ? 1 : S_MAX;   // the static tables' width

  __shared__ float4 s_pos[CAP];              // x y z h, dem-sorted
  __shared__ int s_key[CAP];                 // its pack lane
  __shared__ int s_cnt_n[P * SN];            // candidates a (part, dem)
  __shared__ int s_base_n[P * SN];           // their first sorted place
  __shared__ int s_seg_n[SN + 1];            // a dem's first sorted place
  __shared__ float s_q[5][M];                // qx qy qz qh qvol
  __shared__ unsigned long long s_want[M];   // a lane's dems (0: none)
  __shared__ unsigned long long s_rowwant;
  __shared__ float s_r[TT][M];               // a tile's gated r (-1: none)
  __shared__ float s_t1[TT][M];              // and its t1 = V_q W / r
  // wide: a lane's (rigid, own dem) and the one dem the row skips (-1:
  // none; NO_RIGID: no rigid lane), the tables in dynamic shared memory
  __shared__ int s_rig[WIDE ? M : 1], s_own[WIDE ? M : 1];
  __shared__ int s_rowskip;
  __shared__ long long s_orow[M];            // a lane's output row (-1: none)
  extern __shared__ int s_dyn[];
  const int SC = WIDE ? a.chunk : S_MAX;     // the tables' row stride
  int* const s_cnt = WIDE ? s_dyn : s_cnt_n;                 // [P][SC]
  int* const s_base = WIDE ? s_dyn + P * SC : s_base_n;      // [P][SC]
  int* const s_seg = WIDE ? s_dyn + 2 * P * SC : s_seg_n;    // [SC + 1]

  const int t = threadIdx.x, lane = t & 31;
  const int c = t / M, l = t % M;            // lane group, query lane
  const unsigned lt = (1u << lane) - 1u;
  const int S = a.S;
  const int b = blockIdx.x;                  // the query row
  if (b >= a.NI) {                           // particle rows: the orphans
    zero_orphans(a, b - a.NI, s_key);
    return;
  }

  // the query lanes (group 0)
  if (!WIDE) {
    if (t == 0) s_rowwant = 0ull;
    for (int i = t; i < P * S_MAX; i += THREADS) s_cnt[i] = 0;
  }
  __syncthreads();
  if (t < M) {
    const long long qraw = a.qslot[b];
    const long long qs = min(max(qraw, 0LL), (long long)(a.nrows - 1));
    const float* q = a.dft + qs * F * M + l;
    long long orow = ((long long)b * M + l) * 12 * S;
    if (a.lane_pid) {
      const long long lane_id = qraw * M + l;
      const long long p = lane_id >= 0 && lane_id < a.n_lanes
                              ? a.lane_pid[lane_id] : -1LL;
      orow = p >= 0 && p < a.n ? p * 12 * S : -1LL;
    }
    s_orow[l] = orow;
    s_q[0][l] = __ldg(q + FX * M);
    s_q[1][l] = __ldg(q + FY * M);
    s_q[2][l] = TWO_D ? 0.0f : __ldg(q + FZ * M);
    s_q[3][l] = __ldg(q + FH * M);
    s_q[4][l] = __ldg(q + FVOL * M);
    const Flags f = decode(__ldg(q + FFLAGS * M));
    if (!WIDE) {
      unsigned long long want = 0ull;
      if (f.rigid == 1.0f) {
        want = S == 64 ? ~0ull : (1ull << S) - 1ull;
        if (f.dem >= 0.0f && f.dem < (float)S) want &= ~(1ull << (int)f.dem);
      }
      s_want[l] = want;
      if (want) atomicOr(&s_rowwant, want);
    } else {
      s_rig[l] = f.rigid == 1.0f;
      s_own[l] = (f.dem >= 0.0f && f.dem < (float)S) ? (int)f.dem : -1;
    }
  }
  if (WIDE) {
    __syncthreads();
    if (t < 32) {
      const bool rig = t < M && s_rig[t];
      const int own = t < M ? s_own[t] : -1;
      const unsigned rm = __ballot_sync(FULL, rig);
      const int lo = __reduce_min_sync(FULL, rig ? own : 0x7fffffff);
      const int hi = __reduce_max_sync(FULL, rig ? own : -0x7fffffff);
      if (t == 0) s_rowskip = rm == 0u ? NO_RIGID : (lo == hi ? lo : -1);
    }
  }

  __syncthreads();
  // 1. the init row over every lane with an output row: a warp a lane
  // row, 16 bytes a thread a store (they drain while the walks run)
  mofidi::fill_init_rows(a.out, M, S, a.init_dist, t, THREADS, THREADS / 32,
                         [&](int l) { return s_orow[l]; });
  const unsigned long long row_want = WIDE ? 0ull : s_rowwant;
  const int row_skip = WIDE ? s_rowskip : 0;
  if (WIDE ? row_skip == NO_RIGID : row_want == 0ull)
    return;   // no rigid lane: the init row

  // stencil part c: entries [e_lo, e_hi) in order; every part walks
  // `per` steps, so the warps stay converged
  const int per = (a.O + P - 1) / P;
  const int e_lo = c * per, e_hi = min(a.O, e_lo + per);
  const long long* nb = a.nbr + (long long)b * a.O;
  // the flags word of lane l of entry e and its row (a sentinel's flags
  // past the part's end)
  auto entry = [&](int e, long long& r) -> float {
    r = e < e_hi ? nb[e] : -1LL;
    return (r >= 0 && r < a.nrows) ? __ldg(a.dft + (r * F + FFLAGS) * M + l)
                                   : -8.0f;
  };
  // the running sums of query lane l (group 0's, carried across tiles
  // and windows)
  float run[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float run_r = mofidi::kBig;
  int run_pick = 0;
  const float thr = (a.cutoff * a.cutoff) * 1.001f;

  // the dems [d0, d0 + ns) a chunk (narrow: one chunk, d0 = 0, of all S)
  for (int d0 = 0; WIDE ? d0 < S : d0 == 0; d0 += SC) {
    const int ns = WIDE ? min(SC, S - d0) : S;
    // a source lane the gate's flag and dem tests may pass: its dem's
    // place in the chunk, else -1
    auto eligible = [&](float fl) -> int {
      const Flags f = decode(fl);
      if (!WIDE)
        return (f.bdry == 1.0f && f.fluid == 0.0f && f.dem >= 0.0f &&
                f.dem < (float)S && ((row_want >> (int)f.dem) & 1ull))
                   ? (int)f.dem
                   : -1;
      const int d = (int)f.dem - d0;
      return (f.bdry == 1.0f && f.fluid == 0.0f && f.dem >= 0.0f &&
              d >= 0 && d < ns && d + d0 != row_skip)
                 ? d
                 : -1;
    };
    if (WIDE) {
      for (int i = t; i < P * SC; i += THREADS) s_cnt[i] = 0;
      __syncthreads();
    }

    // 2a. count the candidates of each (part, dem)
    for (int e0 = e_lo; e0 < e_lo + per; e0 += UNROLL) {
      float fl[UNROLL];
      long long rr[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) fl[u] = entry(e0 + u, rr[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int d = eligible(fl[u]);
        if (d >= 0) atomicAdd(&s_cnt[c * SC + d], 1);
      }
    }
    __syncthreads();
    // 2b. sorted places: dem-major, then stencil part, then stencil order
    if (!WIDE) {
      if (t < S) {
        int sum = 0;
        for (int p = 0; p < P; ++p) sum += s_cnt[p * SC + t];
        s_seg[t + 1] = sum;
      }
      __syncthreads();
      if (t == 0) {
        s_seg[0] = 0;
        for (int s = 0; s < S; ++s) s_seg[s + 1] += s_seg[s];
      }
      __syncthreads();
      if (t < S) {
        int at = s_seg[t];
        for (int p = 0; p < P; ++p) {
          s_base[p * SC + t] = at;
          at += s_cnt[p * SC + t];
        }
      }
    } else {
      for (int d = t; d < ns; d += THREADS) {
        int sum = 0;
        for (int p = 0; p < P; ++p) sum += s_cnt[p * SC + d];
        s_seg[d + 1] = sum;
      }
      __syncthreads();
      if (t < 32) {   // the prefix sums: a run of dems a lane, then a scan
        const int run_n = (ns + 31) / 32;
        const int lo = min(ns, t * run_n), hi = min(ns, lo + run_n);
        int sum = 0;
        for (int d = lo; d < hi; ++d) sum += s_seg[d + 1];
        int incl = sum;
        for (int off = 1; off < 32; off <<= 1) {
          const int v = __shfl_up_sync(FULL, incl, off);
          if (t >= off) incl += v;
        }
        int at = incl - sum;
        for (int d = lo; d < hi; ++d) {
          at += s_seg[d + 1];
          s_seg[d + 1] = at;
        }
        if (t == 0) s_seg[0] = 0;
      }
      __syncthreads();
      for (int d = t; d < ns; d += THREADS) {
        int at = s_seg[d];
        for (int p = 0; p < P; ++p) {
          s_base[p * SC + d] = at;
          at += s_cnt[p * SC + d];
        }
      }
    }
    const int total = s_seg[ns];

    // the sorted candidates in windows of CAP (one window but for a very
    // crowded stencil)
    for (int w0 = 0; __syncthreads_or(w0 < total); w0 += CAP) {
      // 2c. place the window's candidates: each part walks its entries in
      // order with a cursor a dem, so a dem's candidates stay in stencil
      // order
      for (int s = t; s < P * SC; s += THREADS) s_cnt[s] = s_base[s];
      __syncthreads();
      for (int e0 = e_lo; e0 < e_lo + per; e0 += UNROLL) {
        float fl[UNROLL];
        long long rr[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) fl[u] = entry(e0 + u, rr[u]);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int d = eligible(fl[u]);
          // lanes of this part's entry with the same dem (unique keys for
          // the others and for the warp's other part)
          const int key = d >= 0 ? (WIDE ? c * SC + d : (c << 8) | d)
                                 : -1 - lane;
          const unsigned peers = __match_any_sync(FULL, key);
          int at = 0;
          if (d >= 0) at = s_cnt[c * SC + d] + __popc(peers & lt);
          __syncwarp();
          if (d >= 0 && (peers & lt) == 0u) s_cnt[c * SC + d] += __popc(peers);
          __syncwarp();
          if (d >= 0 && at >= w0 && at < w0 + CAP) {
            const float* sb = a.dft + rr[u] * F * M + l;
            s_pos[at - w0] =
                make_float4(__ldg(sb + FX * M), __ldg(sb + FY * M),
                            TWO_D ? 0.0f : __ldg(sb + FZ * M),
                            __ldg(sb + FH * M));
            s_key[at - w0] = (int)(rr[u] * M + l);
          }
        }
      }
      __syncthreads();

      // 3. each dem's candidates in the window, TT at a time: the pair
      // bodies in parallel (candidate c * U + u of the tile for query lane
      // l), then group 0 adds them in candidate order
      const unsigned long long want = WIDE ? 0ull : s_want[l];
      const bool rig = WIDE && s_rig[l];
      const int own = WIDE ? s_own[l] : -1;
      const float qx = s_q[0][l], qy = s_q[1][l], qz = s_q[2][l];
      for (int s = 0; s < ns; ++s) {
        const int lo = max(s_seg[s], w0) - w0;
        const int hi = min(s_seg[s + 1], w0 + CAP) - w0;
        if (lo >= hi) continue;                  // block-uniform
        const bool mine = WIDE ? rig && own != d0 + s : (want >> s) & 1ull;
        for (int k0 = lo; k0 < hi; k0 += TT) {
          const float qh = s_q[3][l], qvol = s_q[4][l];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int j = c * U + u, k = k0 + j;
            float rij = -1.0f, t1 = 0.0f;         // -1: no gated pair
            if (mine && k < hi) {
              const float4 sc = s_pos[k];
              const float xij = qx - sc.x;
              const float yij = qy - sc.y;
              float r2 = xij * xij + yij * yij;
              if (!TWO_D) {
                const float zij = qz - sc.z;
                r2 = r2 + zij * zij;
              }
              if (r2 <= thr) {
                const float r = sqrtf(r2);
                if (r <= a.cutoff) {
                  const float wij = sph::w<TWO_D>(
                      r, 0.5f * (qh + sc.w), a.sig_num, a.sig_den);
                  rij = r;
                  t1 = qvol * (1.0f / fmaxf(r, 1e-30f)) * wij;
                }
              }
            }
            s_r[j][l] = rij;
            s_t1[j][l] = t1;
          }
          __syncthreads();
          if (c == 0 && mine) {
            const int n = min(TT, hi - k0);
            for (int j = 0; j < n; ++j) {
              const float rij = s_r[j][l];
              if (rij < 0.0f) continue;
              const float4 sc = s_pos[k0 + j];
              const float xij = qx - sc.x, yij = qy - sc.y, zij = qz - sc.z;
              const float t1 = s_t1[j][l];
              const float t2 = t1 * rij;
              run[0] += t1 * xij;
              run[1] += t1 * yij;
              run[3] += t2;
              run[4] += t2 * xij;
              run[5] += t2 * yij;
              if (!TWO_D) {
                run[2] += t1 * zij;
                run[6] += t2 * zij;
              }
              if (rij < run_r) {   // the lowest stencil lane on a tie
                run_r = rij;
                run_pick = s_key[k0 + j];
              }
            }
          }
          __syncthreads();   // s_r and s_t1 are written again
        }
        if (c == 0 && s_seg[s + 1] <= w0 + CAP) {   // the dem's end
          const long long orow = s_orow[l];
          if (orow >= 0 && mine && run_r < mofidi::kBig) {
            // 4. the epilogue, the picked source read by its pack lane
            const float* sb = a.dft + (long long)(run_pick / M) * F * M +
                              run_pick % M;
            mofidi::store_row(
                a.out + orow + d0 + s, S, a.init_dist, run[0], run[1],
                run[2], run[3], run[4], run[5], run[6], run_r,
                __ldg(sb + FX * M), __ldg(sb + FY * M),
                TWO_D ? 0.0f : __ldg(sb + FZ * M), __ldg(sb + FU * M),
                __ldg(sb + FV * M), TWO_D ? 0.0f : __ldg(sb + FW * M));
          }
#pragma unroll
          for (int m = 0; m < 7; ++m) run[m] = 0.0f;
          run_r = mofidi::kBig;
        }
      }
    }
  }
}

// the query rows and, for particle rows, the zeroing blocks
inline unsigned blocks(const Args& a) {
  return (unsigned)a.NI +
         (a.lane_pid ? (unsigned)((a.n + ORPHANS - 1) / ORPHANS) : 0u);
}

template <bool TWO_D>
int launch(const Args& a, cudaStream_t st) {
  contact_kernel<TWO_D, false><<<blocks(a), THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// the wide instance: its dynamic shared memory allowed once an instance
template <bool TWO_D>
int launch_wide(const Args& a, cudaStream_t st) {
  static int opted = 0;   // the dynamic shared memory allowed so far
  const int bytes = wide_bytes(a.chunk);
  if (bytes > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        contact_kernel<TWO_D, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    opted = bytes;
  }
  contact_kernel<TWO_D, true><<<blocks(a), THREADS, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// chunk: 0 runs the narrow instance (S <= 64); else the wide one with
// `chunk` dems a chunk (1 .. min(S, 2048)), the wrapper's choice
// (ops/contact_kernel.py contact_instance).  sph_id: the SPH kernel's id
// (ops/kernels.py Kernel.device_id), which must be the one this library
// was built for.  lane_pid null: out [NI, M, 12 S] by query row; else out
// [n, 12 S] by particle, lane_pid [n_lanes] the particle of each pack
// lane (outside [0, n): none) and dense_pos [n] each particle's pack lane
// (>= n_lanes: none; its row is zeros).
extern "C" int contact_sums(const void* dft, const void* qslot,
                            const void* nbr, void* out,
                            const void* lane_pid, const void* dense_pos,
                            int NI, int O, int nrows, int lanes, int S,
                            int chunk, int n, int n_lanes, int two_d,
                            int sph_id, float cutoff, float init_dist,
                            float sig_num, float sig_den, void* stream) {
  // a pack lane is an int
  if (sph_id != sph::kId || lanes != M || S < 1 || O < 0 || nrows < 1 ||
      (long long)nrows * M >= (1LL << 31) || chunk < 0 ||
      chunk > WIDE_CHUNK || chunk > S || (chunk == 0 && S > S_MAX) ||
      NI < 0 || (lane_pid && (!dense_pos || n < 0 || n_lanes < 0)))
    return (int)cudaErrorInvalidValue;
  Args a{(const float*)dft, (const long long*)qslot, (const long long*)nbr,
         (float*)out, (const long long*)lane_pid,
         (const long long*)dense_pos, NI, O, nrows, S, chunk,
         lane_pid ? n : 0, n_lanes, cutoff, init_dist, sig_num, sig_den};
  if (blocks(a) == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (chunk > 0)
    return two_d ? launch_wide<true>(a, st) : launch_wide<false>(a, st);
  return two_d ? launch<true>(a, st) : launch<false>(a, st);
}
