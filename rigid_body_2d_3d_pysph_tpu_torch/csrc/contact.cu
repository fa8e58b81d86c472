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
// and the epilogue of pallas_contact.py:313-328, writing
// out[b][l][c * S + s] for the 12 column blocks c: cfn x/y/z, wij sum,
// contact distance, closest distance, picked source x/y/z/u/v/w; every
// (lane, s) without a gated pair, and every padding row, holds the init
// row.  The gate is: source on the contact boundary, not fluid, of
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
// 12 S words per lane of every row, is the only large byte stream (80 MB
// when every slot of the 2D stack is a query).
// Design: one block of 128 threads a query row: M query lanes times P =
// 128 / M lane groups, so even the few hundred culled rows of the main
// path fill the card.
// 1. The block writes the init row over the row's output (16-byte
//    stores); a row with no rigid lane stops here.
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
// 4. The epilogue (csrc/mofidi.cuh store_row) for each (lane, dem) with
//    a gated pair, the picked source's fields read from the pack by its
//    lane.
// A stencil with more than CAP candidates is sorted and summed in windows
// of CAP (a second walk per window; group 0 carries a dem's sums across
// them).  Nothing goes through a matrix unit.  Built with
// --fmad=false so r rounds as the plain version's does and the picks,
// distance ties included, agree bit for bit.
#include "mofidi.cuh"

namespace {

constexpr int M = 16;          // lanes a slot (the contact grids' width)
constexpr int THREADS = 128;   // a block: one query row
constexpr int CAP_3D = 1536;   // sorted candidates a window: 3D,
constexpr int CAP_2D = 512;    // 2D (a 2D stencil holds ~16 x 16 lanes)
constexpr int UNROLL = 8;      // stencil entries whose loads are in flight
constexpr int S_MAX = 64;      // a dem is a bit of a 64-bit mask
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* dft;              // [nrows, F, M]
  const long long* qslot;        // [NI]
  const long long* nbr;          // [NI, O]
  float* out;                    // [NI, M, 12 S]
  int NI, O, nrows, S;
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

template <bool TWO_D>
__global__ void __launch_bounds__(THREADS)
    contact_kernel(const Args a) {
  constexpr int F = TWO_D ? 7 : 9;
  constexpr int FX = 0, FY = 1, FZ = 2;
  constexpr int FU = TWO_D ? 2 : 3, FV = TWO_D ? 3 : 4, FW = 5;
  constexpr int FVOL = TWO_D ? 4 : 6, FH = TWO_D ? 5 : 7;
  constexpr int FFLAGS = TWO_D ? 6 : 8;
  constexpr int P = THREADS / M;     // lane groups: stencil parts
  constexpr int CAP = TWO_D ? CAP_2D : CAP_3D;
  constexpr int U = 8;               // pair bodies a thread, a tile
  constexpr int TT = P * U;          // candidates a tile

  __shared__ float4 s_pos[CAP];              // x y z h, dem-sorted
  __shared__ int s_key[CAP];                 // its pack lane
  __shared__ int s_cnt[P][S_MAX];            // candidates a (part, dem)
  __shared__ int s_base[P][S_MAX];           // their first sorted place
  __shared__ int s_seg[S_MAX + 1];           // a dem's first sorted place
  __shared__ float s_q[5][M];                // qx qy qz qh qvol
  __shared__ unsigned long long s_want[M];   // a lane's dems (0: none)
  __shared__ unsigned long long s_rowwant;
  __shared__ float s_r[TT][M];               // a tile's gated r (-1: none)
  __shared__ float s_t1[TT][M];              // and its t1 = V_q W / r

  const int t = threadIdx.x, lane = t & 31;
  const int c = t / M, l = t % M;            // lane group, query lane
  const unsigned lt = (1u << lane) - 1u;
  const int S = a.S;
  const int b = blockIdx.x;                  // the query row

  // the query lanes (group 0)
  if (t == 0) s_rowwant = 0ull;
  for (int i = t; i < P * S_MAX; i += THREADS) (&s_cnt[0][0])[i] = 0;
  __syncthreads();
  if (t < M) {
    const long long qs = min(max(a.qslot[b], 0LL), (long long)(a.nrows - 1));
    const float* q = a.dft + qs * F * M + l;
    s_q[0][l] = __ldg(q + FX * M);
    s_q[1][l] = __ldg(q + FY * M);
    s_q[2][l] = TWO_D ? 0.0f : __ldg(q + FZ * M);
    s_q[3][l] = __ldg(q + FH * M);
    s_q[4][l] = __ldg(q + FVOL * M);
    const Flags f = decode(__ldg(q + FFLAGS * M));
    unsigned long long want = 0ull;
    if (f.rigid == 1.0f) {
      want = S == 64 ? ~0ull : (1ull << S) - 1ull;
      if (f.dem >= 0.0f && f.dem < (float)S) want &= ~(1ull << (int)f.dem);
    }
    s_want[l] = want;
    if (want) atomicOr(&s_rowwant, want);
  }

  // 1. the init row over the row's output
  float* orow = a.out + (long long)b * M * 12 * S;
  {
    float4* o4 = reinterpret_cast<float4*>(orow);
    const int per_lane = 3 * S;    // float4 a lane (12 S words)
    for (int i = t; i < M * per_lane; i += THREADS) {
      const int c0 = (i % per_lane) * 4;   // block 5 is columns [5S, 6S)
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = (c0 + j >= 5 * S && c0 + j < 6 * S) ? a.init_dist : 0.0f;
      o4[i] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncthreads();
  const unsigned long long row_want = s_rowwant;
  if (row_want == 0ull) return;   // no rigid lane: the init row

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
  // a source lane the gate's flag and dem tests may pass: its dem, else -1
  auto eligible = [&](float fl) -> int {
    const Flags f = decode(fl);
    return (f.bdry == 1.0f && f.fluid == 0.0f && f.dem >= 0.0f &&
            f.dem < (float)S && ((row_want >> (int)f.dem) & 1ull))
               ? (int)f.dem
               : -1;
  };

  // 2a. count the candidates of each (part, dem)
  for (int e0 = e_lo; e0 < e_lo + per; e0 += UNROLL) {
    float fl[UNROLL];
    long long rr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) fl[u] = entry(e0 + u, rr[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int d = eligible(fl[u]);
      if (d >= 0) atomicAdd(&s_cnt[c][d], 1);
    }
  }
  __syncthreads();
  // 2b. sorted places: dem-major, then stencil part, then stencil order
  if (t < S) {
    int sum = 0;
    for (int p = 0; p < P; ++p) sum += s_cnt[p][t];
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
      s_base[p][t] = at;
      at += s_cnt[p][t];
    }
  }
  const int total = s_seg[S];

  // the running sums of query lane l (group 0's, carried across tiles
  // and windows)
  float run[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float run_r = mofidi::kBig;
  int run_pick = 0;
  const float thr = (a.cutoff * a.cutoff) * 1.001f;

  // the sorted candidates in windows of CAP (one window but for a very
  // crowded stencil)
  for (int w0 = 0; __syncthreads_or(w0 < total); w0 += CAP) {
    // 2c. place the window's candidates: each part walks its entries in
    // order with a cursor a dem, so a dem's candidates stay in stencil
    // order
    for (int s = t; s < P * S_MAX; s += THREADS)
      (&s_cnt[0][0])[s] = (&s_base[0][0])[s];
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
        const int key = d >= 0 ? (c << 8) | d : -1 - lane;
        const unsigned peers = __match_any_sync(FULL, key);
        int at = 0;
        if (d >= 0) at = s_cnt[c][d] + __popc(peers & lt);
        __syncwarp();
        if (d >= 0 && (peers & lt) == 0u) s_cnt[c][d] += __popc(peers);
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
    const unsigned long long want = s_want[l];
    const float qx = s_q[0][l], qy = s_q[1][l], qz = s_q[2][l];
    for (int s = 0; s < S; ++s) {
      const int lo = max(s_seg[s], w0) - w0;
      const int hi = min(s_seg[s + 1], w0 + CAP) - w0;
      if (lo >= hi) continue;                  // block-uniform
      const bool mine = (want >> s) & 1ull;
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
      if (c == 0 && mine && s_seg[s + 1] <= w0 + CAP) {   // the dem's end
        if (run_r < mofidi::kBig) {
          // 4. the epilogue, the picked source read by its pack lane
          const float* sb = a.dft + (long long)(run_pick / M) * F * M +
                            run_pick % M;
          mofidi::store_row(
              orow + l * 12 * S + s, S, a.init_dist, run[0], run[1], run[2],
              run[3], run[4], run[5], run[6], run_r, __ldg(sb + FX * M),
              __ldg(sb + FY * M), TWO_D ? 0.0f : __ldg(sb + FZ * M),
              __ldg(sb + FU * M), __ldg(sb + FV * M),
              TWO_D ? 0.0f : __ldg(sb + FW * M));
        }
#pragma unroll
        for (int m = 0; m < 7; ++m) run[m] = 0.0f;
        run_r = mofidi::kBig;
      }
    }
  }
}

template <bool TWO_D>
int launch(const Args& a, cudaStream_t st) {
  contact_kernel<TWO_D><<<a.NI, THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// sph_id: the SPH kernel's id (ops/kernels.py Kernel.device_id), which must
// be the one this library was built for
extern "C" int contact_sums(const void* dft, const void* qslot,
                            const void* nbr, void* out, int NI, int O,
                            int nrows, int lanes, int S, int two_d, int sph_id,
                            float cutoff, float init_dist, float sig_num,
                            float sig_den, void* stream) {
  // a pack lane is an int
  if (sph_id != sph::kId || lanes != M || S < 1 || S > S_MAX || O < 0 ||
      nrows < 1 || (long long)nrows * M >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (NI == 0) return 0;
  Args a{(const float*)dft, (const long long*)qslot, (const long long*)nbr,
         (float*)out, NI, O, nrows, S, cutoff, init_dist, sig_num, sig_den};
  const cudaStream_t st = (cudaStream_t)stream;
  return two_d ? launch<true>(a, st) : launch<false>(a, st);
}
