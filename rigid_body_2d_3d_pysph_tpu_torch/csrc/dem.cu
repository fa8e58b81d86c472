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
//    the LVC force, the match against the query's input table (its
//    idx/dem in shared memory), the spring update (a continuing
//    contact's slot is final, so its new spring is written out at once).
//    Results go to shared memory.  A pair's result depends only on the
//    query's input table, never on another pair of the same query.
// 3. per query, in candidate order (its mask's bits): the six sums (the
//    summation order of a thread walking its candidates, so the sums
//    equal the plain walk's bit for bit), the matched mask, the new
//    contacts parked in rank order in the particle's output row.  After
//    the scan the unmatched slots are freed and the r-th new contact
//    takes the r-th free slot; the table row is read and written with
//    16-byte accesses.  A list never drops a pair: it is emptied whenever
//    it could not take another 32, so a query or a block may have any
//    number of pairs.
// Measured on an H100 (PERF.md): the scan and its lists take about half
// the time, the pair bodies a third; a candidate-major scan (lanes over
// candidates, a loop over the slot's live queries) was slower.
// No matrix unit, no prefix product, no reduced precision: idx and dem
// are exact copies.  Built with --fmad=false so r = sqrt(x*x + y*y +
// z*z) rounds as the plain version's does and the gate decisions (which
// decide table membership) agree bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int NF = 13;
constexpr int L_MAX = 8;
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

// a particle's table row of L ints: two 16-byte accesses when L = L_MAX
// (rows 32-byte aligned), else one word at a time
__device__ __forceinline__ void load_row(const int* src, bool vec, int L,
                                         int (&v)[L_MAX]) {
  if (vec) {
    const int4 lo = __ldg(reinterpret_cast<const int4*>(src));
    const int4 hi = __ldg(reinterpret_cast<const int4*>(src) + 1);
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
    v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
  } else {
#pragma unroll
    for (int k = 0; k < L_MAX; ++k) v[k] = k < L ? src[k] : -1;
  }
}

__device__ __forceinline__ void store_row(int* dst, bool vec, int L,
                                          const int (&v)[L_MAX]) {
  if (vec) {
    reinterpret_cast<int4*>(dst)[0] = make_int4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<int4*>(dst)[1] = make_int4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < L_MAX; ++k)
      if (k < L) dst[k] = v[k];
  }
}

template <int M, bool ROWWIN>
__global__ void __launch_bounds__(THREADS, 4) dem_pairs_kernel(const Args a) {
  constexpr int G = THREADS / M;      // query rows a block
  constexpr int TM = TILE * M;        // candidate lanes a row stages a round
  // staged live candidates: x y z and the pack lane (row * M + lane) as
  // the int bits of w
  __shared__ float4 s_pos[G * TM];
  __shared__ int s_cnt[G];
  __shared__ int s_tidx[L_MAX * THREADS];   // the query lanes' input tables
  __shared__ int s_tdem[L_MAX * THREADS];
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
  const bool vec = L == L_MAX &&
      ((reinterpret_cast<size_t>(a.t_idx) | reinterpret_cast<size_t>(a.t_dem) |
        reinterpret_cast<size_t>(a.o_idx) | reinterpret_cast<size_t>(a.o_dem)) &
       15) == 0;
  if (live) {
    int ti[L_MAX], td[L_MAX];
    load_row(a.t_idx + (long long)p * L, vec, L, ti);
    load_row(a.t_dem + (long long)p * L, vec, L, td);
#pragma unroll
    for (int k = 0; k < L_MAX; ++k) {
      s_tidx[k * THREADS + t] = ti[k];
      s_tdem[k * THREADS + t] = td[k];
    }
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

      // the table entry of this partner, if any
      int slot = -1;
#pragma unroll
      for (int k = 0; k < L_MAX; ++k)
        if (k < L && slot < 0 && s_tidx[k * THREADS + own] == j &&
            s_tdem[k * THREADS + own] == dem)
          slot = k;
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
        matched |= 1u << c;
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
  if (!live) return;

  // unmatched slots are free; the r-th new contact takes the r-th free
  // slot (parked contact r sits at slot r of the output row)
  const long long base = (long long)p * L;
  const unsigned free_mask = ~matched & ((1u << L) - 1u);
  int nj[L_MAX], nd[L_MAX];
  int n_live = 0;
#pragma unroll
  for (int k = 0; k < L_MAX; ++k) {
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
  store_row(a.o_idx + base, vec, L, nj);
  store_row(a.o_dem + base, vec, L, nd);
  float4* os = reinterpret_cast<float4*>(a.o_sum + (long long)p * 8);
  os[0] = make_float4(f[0], f[1], f[2], f[3]);
  os[1] = make_float4(f[4], f[5], (float)n_live, (float)n_gated);
}

template <int M, bool ROWWIN>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int G = THREADS / M;
  dem_pairs_kernel<M, ROWWIN><<<(a.rows + G - 1) / G, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool ROWWIN>
int dispatch(int M, const Args& a, void* stream) {
  if (a.rows == 0 || a.N == 0) return 0;
  if (M == 8) return launch<8, ROWWIN>(a, (cudaStream_t)stream);
  if (M == 16) return launch<16, ROWWIN>(a, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

bool bad_shape(int L, int E) {
  return L < 1 || L > L_MAX || E < 0 || E > E_MAX;
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
                        int O, int M, int L, int E, float dt, float cutoff,
                        void* stream) {
  if (bad_shape(L, E) || O < 0) return (int)cudaErrorInvalidValue;
  Args a = tables(t_idx, t_dem, t_x, t_y, t_z, mat, o_sum, o_idx, o_dem,
                  o_spr, N, L, E, dt, cutoff);
  a.pack = (const float*)dft;
  a.rows = NC;
  a.nbr = (const long long*)nbr;
  a.O = O;
  return dispatch<false>(M, a, stream);
}

extern "C" int dem_rowwin(const void* dfs, const void* runs,
                          const void* run_cnt, const void* t_idx,
                          const void* t_dem, const void* t_x, const void* t_y,
                          const void* t_z, const void* mat, void* o_sum,
                          void* o_idx, void* o_dem, void* o_spr, int N,
                          int NCW, int R, int M, int L, int E, float dt,
                          float cutoff, void* stream) {
  if (bad_shape(L, E) || R < 1 || R > R_MAX)
    return (int)cudaErrorInvalidValue;
  Args a = tables(t_idx, t_dem, t_x, t_y, t_z, mat, o_sum, o_idx, o_dem,
                  o_spr, N, L, E, dt, cutoff);
  a.pack = (const float*)dfs;
  a.rows = NCW;
  a.runs = (const long long*)runs;
  a.run_cnt = (const long long*)run_cnt;
  a.R = R;
  return dispatch<true>(M, a, stream);
}
