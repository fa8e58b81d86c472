// DEM LVC-displacement pair pass with the fused contact-table update:
// one kernel template, two entry points that differ only in how a query
// row enumerates its candidate source rows.
//
// Replaces the TPU kernels of rigid_body_2d_3d_pysph_tpu/ops/pallas_dem.py:
//   dem_cell    <- _kernel (wrapper dem_sums_pallas /
//                  lvc_displacement_cell_pallas), the spill-grid kernel;
//   dem_rowwin  <- _win_kernel (wrapper lvc_displacement_rowwin_pallas),
//                  the row-window kernel;
// both around the pair body _dem_pair_body.  For each query lane it
// computes, over its candidate source lanes in order, the Luding LVC
// normal force, the tangential spring force with its Coulomb cap, the
// torque, and the contact-table update: match by (partner index, dem id),
// free every unmatched slot (the prune, fused: with cutoff >= 2 max(rad)
// every still-overlapping partner is a candidate), give the r-th new
// contact the r-th free slot with a zero spring, write the table back.
//
// Source pack (both kernels): [rows + 1, 13, M] f32, fields x y z u v w
// wx wy wz rad m dem idx; dem and idx are exact floats, an empty lane has
// idx -1; the pack's rows are the query rows too (slots or windows).
// Candidate order: dem_cell walks the slot's stencil row nbr[s][0..O)
// (entries >= NC are missing), dem_rowwin walks the window's R runs,
// slot by slot up to run_cnt (the overhang slots past run_cnt are never
// read), and both walk lanes within a slot in order.
// Gate: j >= 0, j != self, r <= cutoff, r > 0, overlap > 0.
//
// Tables and outputs (both kernels) are per particle, the query lane's
// idx field naming its particle: the table [N, L] in; sums [N, 8] (fx fy
// fz torx tory torz, live entries, gated pairs), idx/dem [N, L] int32
// and springs [3, N, L] out.  A particle with no lane, and the spring of
// every slot that holds no continuing contact, keep the wrapper's fill
// (zero sums, -1 table entries, zero springs).
//
// Bound on the card: instructions in the candidate scan, not bytes.  A
// 2D spill-grid query walks O x M = 384 candidate lanes at ~100k grains,
// of which ~200 are live and ~4 pass the gate; the table moves 160 bytes
// (L = 8) per particle each way.
// Design: a block of 128 query lanes (128 / M slots or windows), three
// phases, so that the full pair body runs on dense pairs and the
// per-query state is a few registers:
// 1. gate scan.  Each slot's candidates are staged TILE stencil entries
//    (run slots) at a time into shared memory with coalesced loads: only
//    the live lanes (idx >= 0), in order, one float4 each (x y z and the
//    lane's pack position).  A query lane tests them, two a round,
//    against the distance filter r^2 <= 1.001 cutoff^2 (no sqrt, r^2 by
//    fma, its own lane excluded; a pair it drops fails r <= cutoff
//    exactly) and its warp appends the hits to the warp's pair list
//    (ballot + popc: no atomics), so each query's pairs stay in candidate
//    order; the query's lane keeps a bit mask of its entries.
// 2. pair body.  When the list could not take another 32, and at the
//    end, the warp's 32 threads take its pairs one each: the exact gate,
//    the LVC force, the match against the query's input table, the
//    spring update (a continuing contact's slot is final, so its new
//    spring is written out at once).  Results go to shared memory.  A
//    pair's result depends only on the query's input table, never on
//    another pair of the same query.
// 3. per query, in candidate order (its mask's bits): the six sums (the
//    summation order of a thread walking its candidates, so the sums
//    equal the plain walk's bit for bit), the matched slots, the new
//    contacts parked in rank order in the particle's output row.  After
//    the scan the unmatched slots are freed and the r-th new contact
//    takes the r-th free slot.  A list never drops a pair: it is emptied
//    whenever it could not take another 32, so a query or a block may
//    have any number of pairs.
// Measured on an H100 (PERF.md): the scan and its lists take about half
// the time, the pair bodies a third; a candidate-major scan (lanes over
// candidates, a loop over the slot's live queries) was slower.
//
// Table widths: two instances, the same slot for every contact in both.
// * Narrow (LM = 8, L <= 8): each query lane loads its row into
//   registers (two 16-byte accesses when L = 8) and shared memory, the
//   pair body tests its 8 slots, the matched slots are a register mask
//   and the row is written back from registers.
// * Wide (any L > 8 up to MAX_WIDE_L, the width a runtime argument; the
//   wrapper picks the instance: ops/dem_kernel.py table_instance).  What
//   a wide table must cost is its bytes (5L words a particle each way),
//   but a row holds few live entries (<= 7 on the 3D column's lattice),
//   so no step walks every slot for a pair:
//   - staging: a warp reads its query lanes' rows RB at a time, its lanes
//     across a row's words (coalesced, all RB rows' loads in flight), and
//     compacts each row's live entries (idx >= 0) with a ballot into a
//     list a query in shared memory, in slot order: key (idx | dem << 24)
//     and slot, at most CL of them;
//   - the pair body matches against the list; a row with more than CL
//     live entries, or one whose key does not fit, matches against its
//     row in global memory slot by slot instead (exact, slower: crowded
//     tables);
//   - the matched slots are a bitmap a query in shared memory (ceil(L /
//     32) words, sized on the host with the lists: dynamic shared
//     memory), set by the query's own thread in phase 3;
//   - write-back, every slot of each row: a matched slot its entry from
//     the list, a free slot of rank r the r-th parked new contact if r <
//     new contacts, else -1; parked contact r sits at slot r <= every
//     slot that takes it, so slots are written from the last down, each
//     after the parked entries below it are read.  Rows of up to
//     ROW_WARP slots: each thread writes its own in 16-byte pieces;
//     wider rows: the warp writes each row in turn, lanes across its
//     words, so that a store fills whole sectors (pieces of 32 scattered
//     rows an instruction cost ~0.1 ms more at L = 40 on the 3D column,
//     whose table is then past the L2 cache).
//   Measured on the 3D column (122,915 grains; NVIDIA H100 80GB HBM3,
//   700 W; scripts/dem_variants.py, PERF.md), K4 alone at L = 8 / 12 /
//   16 / 32 / 40: 0.1554 / 0.1839 / 0.1900 / 0.2290 / 0.2447 ms, bounds
//   by bytes 0.0148 / 0.0207 / 0.0266 / 0.0500 / 0.0618.  Past L = 8 the
//   staging and write-back add ~0.02 ms at L = 12 and grow with the
//   bytes, the scan ~0.005 (shared memory for the lists), the pair
//   bodies ~0.003.
// No matrix unit, no prefix product, no reduced precision: idx and dem
// are exact copies.  Built with --fmad=false so r = sqrt(x*x + y*y +
// z*z) rounds as the plain version's does and the gate decisions (which
// decide table membership) agree bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int NF = 13;
constexpr int L_VEC = 8;     // the table width of the 16-byte row path
constexpr int WIDE = 0;      // LM of the instance of any table width
constexpr int CL = 16;       // live entries a query's list holds (wide;
                             // ops/dem_kernel.py WIDE_LIST)
constexpr int CS = CL + 1;   // the list's stride a query (no bank clash)
constexpr int RB = 8;        // rows a warp stages at once (wide)
constexpr int ROW_WARP = 16; // wider rows: the warp writes each (wide)
constexpr int NO_LIST = 1 << 30;   // a row's count when it takes no list
constexpr int MAX_WIDE_L = 8192;   // the wide instance's widest table
constexpr int E_MAX = 8;
constexpr int R_MAX = 9;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 8;      // stencil entries (run slots) staged a round
constexpr int LIST = 64;     // pair-list entries a warp (a lane's: a bit
                             // mask of 64)
constexpr unsigned FULL = 0xffffffffu;
constexpr int NEW_CONTACT = -1, NOT_GATED = -2;   // pair codes (else: slot)
enum { FX = 0, FY, FZ, FU, FV, FW, FWX, FWY, FWZ, FRAD, FM, FDEM, FIDX };

struct Args {
  const float* pack;             // [rows + 1, 13, M]
  int rows;                      // query rows; row `rows` is all-sentinel
  const long long* nbr;          // dem_cell: [rows, O] source rows
  int O;
  const long long* runs;         // dem_rowwin: [rows, R] first slot of a run
  const long long* run_cnt;      // [rows, R] slots in the run
  int R;
  const int* t_idx;              // [N, L] input table
  const int* t_dem;
  const float* t_x;
  const float* t_y;
  const float* t_z;
  const float* mat;              // [E, 4] kn kt alpha mu
  float* o_sum;                  // [N, 8]
  int* o_idx;                    // [N, L]
  int* o_dem;
  float* o_spr;                  // [3, N, L]
  int N, L, E;
  float dt, cutoff;
};

// a particle's table row of L ints into LM registers: two 16-byte
// accesses when L = LM = 8 (rows 32-byte aligned), else one word at a time
template <int LM>
__device__ __forceinline__ void load_row(const int* src, bool vec, int L,
                                         int (&v)[LM]) {
  if (vec) {
    const int4 lo = __ldg(reinterpret_cast<const int4*>(src));
    const int4 hi = __ldg(reinterpret_cast<const int4*>(src) + 1);
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
    v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
  } else {
#pragma unroll
    for (int k = 0; k < LM; ++k) v[k] = k < L ? src[k] : -1;
  }
}

template <int LM>
__device__ __forceinline__ void store_row(int* dst, bool vec, int L,
                                          const int (&v)[LM]) {
  if (vec) {
    reinterpret_cast<int4*>(dst)[0] = make_int4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<int4*>(dst)[1] = make_int4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < LM; ++k)
      if (k < L) dst[k] = v[k];
  }
}

// the wide instance's dynamic shared memory (bytes) at table width L: the
// match bitmaps [ceil(L / 32)][THREADS], the lists' keys [THREADS][CS]
// and their slots [THREADS][CS] (16-bit)
__host__ __device__ constexpr int wide_bytes(int L) {
  return ((L + 31) / 32) * THREADS * 4 + THREADS * CS * (4 + 2);
}

// a list entry's key: partner index (< 2^24) and dem id (< 256) in one
// word; false where they do not fit (the row then takes no list)
__device__ __forceinline__ bool list_key(int idx, int dem, unsigned& key) {
  key = (unsigned)idx | ((unsigned)dem << 24);
  return (unsigned)idx < (1u << 24) && (unsigned)dem < 256u;
}

template <int M, bool ROWWIN, int LM>
__global__ void __launch_bounds__(THREADS, 4) dem_pairs_kernel(const Args a) {
  constexpr int G = THREADS / M;      // query rows a block
  constexpr int TM = TILE * M;        // candidate lanes a row stages a round
  constexpr bool wide = LM == WIDE;
  // staged live candidates: x y z and the pack lane (row * M + lane) as
  // the int bits of w
  __shared__ float4 s_pos[G * TM];
  __shared__ int s_cnt[G];
  // narrow: the query lanes' input tables [LM][THREADS]
  constexpr int LS = wide ? 1 : LM;
  __shared__ int s_tidx[LS * THREADS];
  __shared__ int s_tdem[LS * THREADS];
  // wide: each query's list length (NO_LIST: the row in global memory)
  __shared__ int s_nin[wide ? THREADS : 1];
  extern __shared__ int s_dyn[];
  const int W = (a.L + 31) >> 5;             // match bitmap words a query
  unsigned* const s_match = reinterpret_cast<unsigned*>(s_dyn);
  unsigned* const c_key = s_match + W * THREADS;
  unsigned short* const c_slot =
      reinterpret_cast<unsigned short*>(c_key + THREADS * CS);
  __shared__ int l_src[WARPS * LIST];       // per warp: the pair list
  __shared__ int l_own[WARPS * LIST];
  __shared__ int l_code[WARPS * LIST];
  __shared__ float l_f[WARPS * 6 * LIST];
  __shared__ float s_mat[E_MAX * 4];
  __shared__ int s_run0[ROWWIN ? G * R_MAX : 1];
  __shared__ int s_pre[ROWWIN ? G * (R_MAX + 1) : 1];

  const int t = threadIdx.x, lane = t & 31, wp = t >> 5;
  const int g = t / M, l = t % M;
  const int lane0 = lane & ~(M - 1);         // the row's first lane
  const unsigned gmask = ((1u << M) - 1u) << lane0;   // the row's lanes
  const unsigned lt = (1u << lane) - 1u;
  const int qrow = blockIdx.x * G + g;
  const int L = a.L;
  if (t < a.E * 4) s_mat[t] = a.mat[t];

  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  int p = -1;
  if (qrow < a.rows) {
    const float* qb = a.pack + (long long)qrow * NF * M + l;
    qx = __ldg(qb + FX * M);
    qy = __ldg(qb + FY * M);
    qz = __ldg(qb + FZ * M);
    p = (int)__ldg(qb + FIDX * M);
  }
  const bool live = p >= 0 && p < a.N;
  const bool vec = LM == L_VEC && L == L_VEC &&
      ((reinterpret_cast<size_t>(a.t_idx) | reinterpret_cast<size_t>(a.t_dem) |
        reinterpret_cast<size_t>(a.o_idx) | reinterpret_cast<size_t>(a.o_dem)) &
       15) == 0;
  if constexpr (!wide) {
    if (live) {
      int ti[LM], td[LM];
      load_row<LM>(a.t_idx + (long long)p * L, vec, L, ti);
      load_row<LM>(a.t_dem + (long long)p * L, vec, L, td);
#pragma unroll
      for (int k = 0; k < LM; ++k) {
        s_tidx[k * THREADS + t] = ti[k];
        s_tdem[k * THREADS + t] = td[k];
      }
    }
  } else {
    for (int w = 0; w < W; ++w) s_match[w * THREADS + t] = 0u;
    // the warp's live rows, RB at a time, lanes across a row's words: the
    // live entries into the query's list in slot order; a row with more
    // than CL of them, or one whose key does not fit, takes no list
    int nin = 0;
    unsigned rows = __ballot_sync(FULL, live);
    while (rows != 0u) {
      int q[RB], pq[RB], n[RB];
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        q[b] = rows != 0u ? __ffs(rows) - 1 : -1;
        rows &= rows - 1u;
        pq[b] = __shfl_sync(FULL, p, q[b] < 0 ? 0 : q[b]);
        n[b] = 0;
      }
      for (int c0 = 0; c0 < L; c0 += 32) {
        const int k = c0 + lane;
        int vi[RB], vd[RB];
#pragma unroll
        for (int b = 0; b < RB; ++b) {
          vi[b] = vd[b] = -1;
          if (q[b] >= 0 && k < L) {
            vi[b] = __ldg(a.t_idx + (long long)pq[b] * L + k);
            vd[b] = __ldg(a.t_dem + (long long)pq[b] * L + k);
          }
        }
#pragma unroll
        for (int b = 0; b < RB; ++b) {
          const bool e = vi[b] >= 0;
          unsigned key;
          const bool fits = list_key(vi[b], vd[b], key);
          const unsigned m = __ballot_sync(FULL, e);
          const int at = n[b] + __popc(m & lt);
          if (e && at < CL) {
            const int o = (wp * 32 + q[b]) * CS + at;
            c_key[o] = key;
            c_slot[o] = (unsigned short)k;
          }
          n[b] += __popc(m);
          if (__any_sync(FULL, e && !fits)) n[b] = NO_LIST;
        }
      }
#pragma unroll
      for (int b = 0; b < RB; ++b)
        if (lane == q[b]) nin = n[b] > CL ? NO_LIST : n[b];
    }
    s_nin[t] = nin;
  }
  if constexpr (ROWWIN) {
    // the window's runs as flat run-slot offsets
    if (l == 0 && qrow < a.rows) {
      int acc = 0;
      for (int r = 0; r < a.R; ++r) {
        const long long c = a.run_cnt[(long long)qrow * a.R + r];
        s_run0[g * R_MAX + r] = (int)a.runs[(long long)qrow * a.R + r];
        s_pre[g * (R_MAX + 1) + r] = acc;
        acc += c > 0 ? (int)c : 0;
      }
      s_pre[g * (R_MAX + 1) + a.R] = acc;
    }
  }
  const bool row_live = (__ballot_sync(FULL, live) & gmask) != 0u;
  const bool warp_live = __any_sync(FULL, live);
  if (!__syncthreads_or(live)) return;   // block-uniform
  int total = 0;                          // candidate entries of this row
  if (row_live) total = ROWWIN ? s_pre[g * (R_MAX + 1) + a.R] : a.O;

  // entry e of this row's candidates -> pack row, -1 if missing
  auto row_of = [&](int e) -> int {
    if (e >= total) return -1;
    long long r;
    if constexpr (ROWWIN) {
      const int* pre = s_pre + g * (R_MAX + 1);
      int k = 0;
      while (e >= pre[k + 1]) ++k;        // runs in order; e < pre[R]
      r = (long long)s_run0[g * R_MAX + k] + (e - pre[k]);
    } else {
      r = a.nbr[(long long)qrow * a.O + e];
    }
    return (r >= 0 && r < a.rows) ? (int)r : -1;
  };

  int* ls = l_src + wp * LIST;
  int* lo = l_own + wp * LIST;
  int* lc = l_code + wp * LIST;
  float* lf = l_f + wp * 6 * LIST;

  // phase 2: the pair body of list entry i
  auto pair = [&](int i) {
    const int own = wp * 32 + lo[i];          // the query lane's thread
    const float* qb = a.pack + (long long)(blockIdx.x * G + own / M) * NF * M +
                      own % M;
    const int src = ls[i];
    const float* sb = a.pack + (long long)(src / M) * NF * M + src % M;
    // every field of both lanes in one round of loads (a listed pair
    // nearly always passes the exact gate)
    float q[NF], s[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      q[f] = __ldg(qb + f * M);
      s[f] = __ldg(sb + f * M);
    }
    int code = NOT_GATED;
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f, c4 = 0.0f, c5 = 0.0f;
    const int qi = (int)q[FIDX];
    const int j = (int)s[FIDX];
    const float xij = q[FX] - s[FX];
    const float yij = q[FY] - s[FY];
    const float zij = q[FZ] - s[FZ];
    const float rij = sqrtf(xij * xij + yij * yij + zij * zij);
    const float overlap = q[FRAD] + s[FRAD] - rij;
    if (s[FIDX] >= 0.0f && j != qi && rij <= a.cutoff && rij > 0.0f &&
        overlap > 0.0f) {
      const int dem = (int)s[FDEM];
      float kn = 0.0f, kt = 0.0f, alpha = 0.0f, mu = 0.0f;
      if (dem >= 0 && dem < a.E) {
        kn = s_mat[4 * dem];
        kt = s_mat[4 * dem + 1];
        alpha = s_mat[4 * dem + 2];
        mu = s_mat[4 * dem + 3];
      }
      const float rinv = 1.0f / fmaxf(rij, 1e-30f);
      const float nx = xij * rinv, ny = yij * rinv, nz = zij * rinv;
      const float a_i = q[FRAD] - overlap / 2.0f;
      const float a_j = s[FRAD] - overlap / 2.0f;
      const float vi_x = q[FU] + (q[FWY] * nz - q[FWZ] * ny) * a_i;
      const float vi_y = q[FV] + (q[FWZ] * nx - q[FWX] * nz) * a_i;
      const float vi_z = q[FW] + (q[FWX] * ny - q[FWY] * nx) * a_i;
      const float vj_x = s[FU] + (-s[FWY] * nz + s[FWZ] * ny) * a_j;
      const float vj_y = s[FV] + (-s[FWZ] * nx + s[FWX] * nz) * a_j;
      const float vj_z = s[FW] + (-s[FWX] * ny + s[FWY] * nx) * a_j;
      const float vij_x = vi_x - vj_x, vij_y = vi_y - vj_y,
                  vij_z = vi_z - vj_z;
      const float vdotn = vij_x * nx + vij_y * ny + vij_z * nz;
      const float vt_x = vij_x - vdotn * nx;
      const float vt_y = vij_y - vdotn * ny;
      const float vt_z = vij_z - vdotn * nz;
      const float m_eff = q[FM] * s[FM] / (q[FM] + s[FM]);
      const float eta_n = alpha * sqrtf(m_eff);
      const float fn = kn * overlap - eta_n * vdotn;
      const float fn_x = fn * nx, fn_y = fn * ny, fn_z = fn * nz;

      // the table entry of this partner, if any (the first slot)
      int slot = -1;
      if constexpr (!wide) {
#pragma unroll
        for (int k = 0; k < LM; ++k)
          if (k < L && slot < 0 && s_tidx[k * THREADS + own] == j &&
              s_tdem[k * THREADS + own] == dem)
            slot = k;
      } else {
        const int nin = s_nin[own];
        if (nin != NO_LIST) {
          // a partner whose key does not fit is in no listed row
          unsigned key;
          if (list_key(j, dem, key)) {
            const int o = own * CS;
            for (int e = 0; e < nin; ++e)
              if (c_key[o + e] == key) {
                slot = c_slot[o + e];
                break;
              }
          }
        } else {
          const int* ti = a.t_idx + (long long)qi * L;
          const int* td = a.t_dem + (long long)qi * L;
          for (int k = 0; k < L && slot < 0; ++k)
            if (ti[k] == j && td[k] == dem) slot = k;
        }
      }
      const long long at = (long long)qi * L + slot;
      float sx = 0.0f, sy = 0.0f, sz = 0.0f;
      if (slot >= 0) {
        sx = a.t_x[at];
        sy = a.t_y[at];
        sz = a.t_z[at];
      }
      // spring projected onto the current contact plane
      const float sdotn = sx * nx + sy * ny + sz * nz;
      sx = sx - sdotn * nx;
      sy = sy - sdotn * ny;
      sz = sz - sdotn * nz;
      float ft_x = -kt * sx - eta_n * vt_x;
      float ft_y = -kt * sy - eta_n * vt_y;
      float ft_z = -kt * sz - eta_n * vt_z;
      const float ft_magn = sqrtf(ft_x * ft_x + ft_y * ft_y + ft_z * ft_z);
      const float inv_ft =
          ft_magn > 1e-12f ? 1.0f / fmaxf(ft_magn, 1e-30f) : 0.0f;
      const float tx = ft_x * inv_ft, ty = ft_y * inv_ft, tz = ft_z * inv_ft;
      const float fn_mu = mu * fn;
      const bool slip = ft_magn > fn_mu;
      if (slip) {
        ft_x = fn_mu * tx;
        ft_y = fn_mu * ty;
        ft_z = fn_mu * tz;
      }
      if (slot >= 0) {
        // a continuing contact keeps its slot: its new spring is final
        const float kt_inv = 1.0f / (kt > 0.0f ? kt : 1.0f);
        const long long NL = (long long)a.N * L;
        a.o_spr[at] = slip ? -kt_inv * (fn_mu * tx + eta_n * vt_x)
                           : sx + vt_x * a.dt;
        a.o_spr[NL + at] = slip ? -kt_inv * (fn_mu * ty + eta_n * vt_y)
                                : sy + vt_y * a.dt;
        a.o_spr[2 * NL + at] = slip ? -kt_inv * (fn_mu * tz + eta_n * vt_z)
                                    : sz + vt_z * a.dt;
        code = slot;
      } else {
        // a new contact: no tangential force this step
        ft_x = ft_y = ft_z = 0.0f;
        code = NEW_CONTACT;
      }
      c0 = fn_x + ft_x;
      c1 = fn_y + ft_y;
      c2 = fn_z + ft_z;
      c3 = (ny * ft_z - nz * ft_y) * a_i;
      c4 = (nz * ft_x - nx * ft_z) * a_i;
      c5 = (nx * ft_y - ny * ft_x) * a_i;
    }
    lc[i] = code;
    lf[0 * LIST + i] = c0;
    lf[1 * LIST + i] = c1;
    lf[2 * LIST + i] = c2;
    lf[3 * LIST + i] = c3;
    lf[4 * LIST + i] = c4;
    lf[5 * LIST + i] = c5;
  };

  float f[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  unsigned matched = 0u;
  int n_new = 0, n_gated = 0;
  int cnt = 0;                               // list length (warp-uniform)
  unsigned long long owned = 0ull;           // this lane's list entries

  // phases 2 and 3 on the warp's list (called by the whole warp)
  auto flush = [&]() {
    __syncwarp();
    for (int i = lane; i < cnt; i += 32) pair(i);
    __syncwarp();
    for (; owned != 0ull; owned &= owned - 1ull) {   // in list order
      const int i = __ffsll((long long)owned) - 1;
      const int c = lc[i];
      if (c == NOT_GATED) continue;
      ++n_gated;
#pragma unroll
      for (int m = 0; m < 6; ++m) f[m] += lf[m * LIST + i];
      if (c >= 0) {
        if constexpr (!wide)
          matched |= 1u << c;
        else
          s_match[(c >> 5) * THREADS + t] |= 1u << (c & 31);
      } else {
        if (n_new < L) {
          // parked at slot n_new of the particle's output row
          const float* sb = a.pack + (long long)(ls[i] / M) * NF * M + ls[i] % M;
          a.o_idx[(long long)p * L + n_new] = (int)__ldg(sb + FIDX * M);
          a.o_dem[(long long)p * L + n_new] = (int)__ldg(sb + FDEM * M);
        }
        ++n_new;
      }
    }
    __syncwarp();
  };

  // r^2 above this means r > cutoff (the exact gate fails); the filter's
  // r^2 is contracted (fma), at most a few ulp from the exact one
  const float thr = (a.cutoff * a.cutoff) * 1.001f;
  const int self = qrow * M + l;
  // candidate k of this row's tile: listed if it may pass the gate
  auto test = [&](const float4* tp, int k, int mine, int& src) -> bool {
    if (k >= mine) return false;
    const float4 c = tp[k];
    const float dx = qx - c.x, dy = qy - c.y, dz = qz - c.z;
    src = __float_as_int(c.w);
    return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx))) <= thr &&
           src != self;
  };
  // append the round's hits in lane order; empty the list when it could
  // not take another 32
  auto append = [&](bool hit, int src) {
    const unsigned b = __ballot_sync(FULL, hit);
    if (hit) {
      const int at = cnt + __popc(b & lt);
      ls[at] = src;
      lo[at] = lane;
      owned |= 1ull << at;
    }
    cnt += __popc(b);
    if (cnt > LIST - 32) {
      flush();
      cnt = 0;
    }
  };
  for (int e0 = 0; __syncthreads_or(e0 < total); e0 += TILE) {
    // stage this round's live candidates of each row, in order
    const int myrow = l < TILE ? row_of(e0 + l) : -1;
    int off = 0;
#pragma unroll 4
    for (int e = 0; e < TILE; ++e) {
      const int r = __shfl_sync(FULL, myrow, lane0 + e);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      bool ok = false;
      if (r >= 0) {
        const float* sb = a.pack + (long long)r * NF * M + l;
        v = make_float4(__ldg(sb + FX * M), __ldg(sb + FY * M),
                        __ldg(sb + FZ * M), __int_as_float(r * M + l));
        ok = __ldg(sb + FIDX * M) >= 0.0f;
      }
      const unsigned b = __ballot_sync(FULL, ok) & gmask;
      if (ok) s_pos[g * TM + off + __popc(b & lt)] = v;
      off += __popc(b);
    }
    if (l == 0) s_cnt[g] = off;
    __syncthreads();
    // phase 1: the gate scan
    if (warp_live) {
      const int mine = live ? s_cnt[g] : 0;
      const int kmax = __reduce_max_sync(FULL, mine);
      const float4* tp = s_pos + g * TM;
      for (int k = 0; k < kmax; k += 2) {
        int s0 = 0, s1 = 0;
        const bool h0 = test(tp, k, mine, s0);
        const bool h1 = test(tp, k + 1, mine, s1);
        if (__any_sync(FULL, h0 || h1)) {
          append(h0, s0);
          append(h1, s1);
        }
      }
    }
  }
  if (warp_live && cnt > 0) flush();

  int n_live = 0;
  if constexpr (!wide) {
    if (!live) return;
    // unmatched slots are free; the r-th new contact takes the r-th free
    // slot (parked contact r sits at slot r of the output row)
    const long long base = (long long)p * L;
    const unsigned free_mask = ~matched & ((1u << L) - 1u);
    int nj[LM], nd[LM];
#pragma unroll
    for (int k = 0; k < LM; ++k) {
      nj[k] = nd[k] = -1;
      if (k >= L) continue;
      if ((matched >> k) & 1u) {
        nj[k] = s_tidx[k * THREADS + t];
        nd[k] = s_tdem[k * THREADS + t];
      } else {
        const int r = __popc(free_mask & ((1u << k) - 1u));
        if (r < n_new) {
          nj[k] = a.o_idx[base + r];
          nd[k] = a.o_dem[base + r];
        }
      }
      n_live += nj[k] >= 0 ? 1 : 0;
    }
    store_row<LM>(a.o_idx + base, vec, L, nj);
    store_row<LM>(a.o_dem + base, vec, L, nd);
  } else {
    if (L <= ROW_WARP) {
      if (!live) return;
      // the thread writes its row whole, from the last slot down: a matched
      // slot copies its entry (from the list, walked down with it, or, a
      // row with no list, the input row), a free slot k takes the parked
      // contact r = free slots below k if r < new contacts (parked at slot
      // r <= k: read before slot r is written), else -1
      const long long base = (long long)p * L;
      const unsigned* mq = s_match + t;                // word w: mq[w * THREADS]
      const int nin = s_nin[t];
      int n_m = 0;                                     // matched slots
      for (int w = 0; w < W; ++w) n_m += __popc(mq[w * THREADS]);
      int m_above = 0;                    // matched slots past the current one
      int e = nin - 1;                    // the list entry at or below it
      auto entry = [&](int k, int& j, int& d) {
        j = d = -1;
        if ((mq[(k >> 5) * THREADS] >> (k & 31)) & 1u) {
          if (nin != NO_LIST) {
            while (c_slot[t * CS + e] > k) --e;
            const unsigned key = c_key[t * CS + e];
            j = (int)(key & 0xffffffu);
            d = (int)(key >> 24);
          } else {
            j = __ldg(a.t_idx + base + k);
            d = __ldg(a.t_dem + base + k);
          }
          ++m_above;
        } else if (k - (n_m - m_above) < n_new) {
          j = a.o_idx[base + k - (n_m - m_above)];
          d = a.o_dem[base + k - (n_m - m_above)];
        }
      };
      const bool vec4 = (L & 3) == 0 &&
          ((reinterpret_cast<size_t>(a.o_idx) |
            reinterpret_cast<size_t>(a.o_dem)) & 15) == 0;
      if (vec4) {
        for (int k = L - 4; k >= 0; k -= 4) {
          int4 vi, vd;
          entry(k + 3, vi.w, vd.w);
          entry(k + 2, vi.z, vd.z);
          entry(k + 1, vi.y, vd.y);
          entry(k, vi.x, vd.x);
          *reinterpret_cast<int4*>(a.o_idx + base + k) = vi;
          *reinterpret_cast<int4*>(a.o_dem + base + k) = vd;
        }
      } else {
        for (int k = L - 1; k >= 0; --k) {
          int j, d;
          entry(k, j, d);
          a.o_idx[base + k] = j;
          a.o_dem[base + k] = d;
        }
      }
      n_live = n_m + min(n_new, L - n_m);
    } else {
      // the warp writes its live rows, lanes across the words: first the
      // free slots, 32-slot chunks from the last down (free slot k takes
      // parked contact r = free slots below k if r < the row's new
      // contacts; parked r <= k is read before slot r is written), then the
      // matched slots, from the list (or, a row with no list, its input row)
      __syncwarp();
      unsigned rows = __ballot_sync(FULL, live);
      while (rows != 0u) {
        const int q = __ffs(rows) - 1;
        rows &= rows - 1u;
        const int own = wp * 32 + q;
        const int pq = __shfl_sync(FULL, p, q);
        const int nq = __shfl_sync(FULL, n_new, q);
        const int nin = s_nin[own];
        const unsigned* mq = s_match + own;           // word w: mq[w * THREADS]
        int n_m = 0;                                  // matched slots
        for (int w = 0; w < W; ++w) n_m += __popc(mq[w * THREADS]);
        const long long base = (long long)pq * L;
        int above = 0;                       // matched slots past the chunk
        for (int w = W - 1; w >= 0; --w) {
          const unsigned mw = mq[w * THREADS];
          const int k = w * 32 + lane;
          const bool is_free = k < L && !((mw >> lane) & 1u);
          int j = -1, d = -1;
          if (nq > 0) {                      // warp-uniform
            const int r = k - (n_m - above - __popc(mw)) - __popc(mw & lt);
            if (is_free && r < nq) {
              j = a.o_idx[base + r];
              d = a.o_dem[base + r];
            }
            __syncwarp();
          }
          if (is_free) {
            a.o_idx[base + k] = j;
            a.o_dem[base + k] = d;
          }
          above += __popc(mw);
        }
        __syncwarp();
        if (nin != NO_LIST) {
          for (int e = lane; e < nin; e += 32) {
            const int k = c_slot[own * CS + e];
            if ((mq[(k >> 5) * THREADS] >> (k & 31)) & 1u) {
              const unsigned key = c_key[own * CS + e];
              a.o_idx[base + k] = (int)(key & 0xffffffu);
              a.o_dem[base + k] = (int)(key >> 24);
            }
          }
        } else {
          for (int w = 0; w < W; ++w) {
            const int k = w * 32 + lane;
            if (k < L && ((mq[w * THREADS] >> lane) & 1u)) {
              a.o_idx[base + k] = __ldg(a.t_idx + base + k);
              a.o_dem[base + k] = __ldg(a.t_dem + base + k);
            }
          }
        }
        if (lane == q) n_live = n_m + min(nq, L - n_m);
      }
      if (!live) return;
    }
  }
  float4* os = reinterpret_cast<float4*>(a.o_sum + (long long)p * 8);
  os[0] = make_float4(f[0], f[1], f[2], f[3]);
  os[1] = make_float4(f[4], f[5], (float)n_live, (float)n_gated);
}

template <int M, bool ROWWIN, int LM>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int G = THREADS / M;
  const int bytes = LM == WIDE ? wide_bytes(a.L) : 0;
  if (bytes > 0) {
    static int allowed = 0;   // the dynamic shared memory allowed so far
    if (bytes > allowed) {
      const cudaError_t err = cudaFuncSetAttribute(
          dem_pairs_kernel<M, ROWWIN, LM>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return (int)err;
      allowed = bytes;
    }
  }
  dem_pairs_kernel<M, ROWWIN, LM>
      <<<(a.rows + G - 1) / G, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int M, bool ROWWIN>
int dispatch_lm(int LM, const Args& a, cudaStream_t stream) {
  if (LM == L_VEC) return launch<M, ROWWIN, L_VEC>(a, stream);
  return launch<M, ROWWIN, WIDE>(a, stream);
}

template <bool ROWWIN>
int dispatch(int M, int LM, const Args& a, void* stream) {
  if (a.rows == 0 || a.N == 0) return 0;
  if (M == 8) return dispatch_lm<8, ROWWIN>(LM, a, (cudaStream_t)stream);
  if (M == 16) return dispatch_lm<16, ROWWIN>(LM, a, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// LM: the instance, 8 (L <= 8) or 0 (the wide one, L <= MAX_WIDE_L)
bool bad_shape(int L, int LM, int E) {
  if (L < 1 || E < 0 || E > E_MAX) return true;
  if (LM == WIDE) return L > MAX_WIDE_L;
  return LM != L_VEC || L > LM;
}

Args tables(const void* t_idx, const void* t_dem, const void* t_x,
            const void* t_y, const void* t_z, const void* mat, void* o_sum,
            void* o_idx, void* o_dem, void* o_spr, int N, int L, int E,
            float dt, float cutoff) {
  Args a{};
  a.t_idx = (const int*)t_idx;
  a.t_dem = (const int*)t_dem;
  a.t_x = (const float*)t_x;
  a.t_y = (const float*)t_y;
  a.t_z = (const float*)t_z;
  a.mat = (const float*)mat;
  a.o_sum = (float*)o_sum;
  a.o_idx = (int*)o_idx;
  a.o_dem = (int*)o_dem;
  a.o_spr = (float*)o_spr;
  a.N = N;
  a.L = L;
  a.E = E;
  a.dt = dt;
  a.cutoff = cutoff;
  return a;
}

}  // namespace

extern "C" int dem_cell(const void* dft, const void* nbr, const void* t_idx,
                        const void* t_dem, const void* t_x, const void* t_y,
                        const void* t_z, const void* mat, void* o_sum,
                        void* o_idx, void* o_dem, void* o_spr, int N, int NC,
                        int O, int M, int L, int LM, int E, float dt,
                        float cutoff, void* stream) {
  if (bad_shape(L, LM, E) || O < 0) return (int)cudaErrorInvalidValue;
  Args a = tables(t_idx, t_dem, t_x, t_y, t_z, mat, o_sum, o_idx, o_dem,
                  o_spr, N, L, E, dt, cutoff);
  a.pack = (const float*)dft;
  a.rows = NC;
  a.nbr = (const long long*)nbr;
  a.O = O;
  return dispatch<false>(M, LM, a, stream);
}

extern "C" int dem_rowwin(const void* dfs, const void* runs,
                          const void* run_cnt, const void* t_idx,
                          const void* t_dem, const void* t_x, const void* t_y,
                          const void* t_z, const void* mat, void* o_sum,
                          void* o_idx, void* o_dem, void* o_spr, int N,
                          int NCW, int R, int M, int L, int LM, int E,
                          float dt, float cutoff, void* stream) {
  if (bad_shape(L, LM, E) || R < 1 || R > R_MAX)
    return (int)cudaErrorInvalidValue;
  Args a = tables(t_idx, t_dem, t_x, t_y, t_z, mat, o_sum, o_idx, o_dem,
                  o_spr, N, L, E, dt, cutoff);
  a.pack = (const float*)dfs;
  a.rows = NCW;
  a.runs = (const long long*)runs;
  a.run_cnt = (const long long*)run_cnt;
  a.R = R;
  return dispatch<true>(M, LM, a, stream);
}
