// DEM LVC-displacement pair pass with the fused contact-table update:
// two entry points over one per-query body.
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
// Source pack (both kernels): [rows, 13, M] f32, fields x y z u v w wx wy
// wz rad m dem idx; dem and idx are exact floats, an empty lane has
// idx -1.  Candidate order: dem_cell walks the slot's stencil row
// nbr[s][0..O) (entries >= NC are missing), dem_rowwin walks the
// window's R runs, slot by slot up to run_cnt (the overhang slots past
// run_cnt are never read), and both walk lanes within a slot in order.
// Gate: j >= 0, j != self, r <= cutoff, r > 0, overlap > 0.
//
// Outputs: dem_cell writes per particle (the query lane's idx field is
// its particle): sums [N, 8] (fx fy fz torx tory torz, live entries,
// gated pairs), idx/dem [N, L] int32, springs [3, N, L]; particles with
// no lane are left as the wrapper filled them.  dem_rowwin writes every
// lane of every window: [NCW, M, 8 + 5L] (the 8 sums, then idx, dem,
// sx, sy, sz as floats); an empty lane gets zero sums and an empty table.
//
// Bound on the card: instruction throughput in the candidate loop, not
// bytes.  A 2D spill-grid query walks O x M = 384 candidate lanes at
// ~100k grains, of which ~4 pass the gate; the kernel moves 160 bytes of
// table (L = 8) per particle each way and reads each source slot once
// per stencil row that names it (mostly from L2).
// Design: one thread per query lane, 128 threads a block covering
// 128 / M slots (or windows); each slot's source lanes pass through its
// own shared-memory tile of TILE stencil entries or run slots (a
// broadcast read: the lanes of a slot read one word at once; group
// strides are padded so groups in one warp hit distinct banks).  The
// table row (5L values), the six sums, the matched mask and the first L
// new candidates live in registers; allocation is a scan over the L
// slots after the pass.  No matrix unit, no prefix product, no reduced
// precision: idx and dem are exact copies.  Built with --fmad=false so
// r = sqrt(x*x + y*y + z*z) rounds as the plain version's does and the
// gate decisions (which decide table membership) agree bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int NF = 13;
constexpr int L_MAX = 8;
constexpr int E_MAX = 8;
constexpr int R_MAX = 9;
constexpr int THREADS = 128;
constexpr int TILE = 4;
enum { FX = 0, FY, FZ, FU, FV, FW, FWX, FWY, FWZ, FRAD, FM, FDEM, FIDX };

struct Query {
  float x, y, z, u, v, w, wx, wy, wz, rad, m;
  int idx;
  int tidx[L_MAX], tdem[L_MAX];
  float tsx[L_MAX], tsy[L_MAX], tsz[L_MAX];
  unsigned matched;
  int n_new, n_gated;
  int nj[L_MAX], nd[L_MAX];
  float f[6];
};

__device__ __forceinline__ void load_query(Query& q, const float* row, int M,
                                           int l) {
  q.x = row[FX * M + l];
  q.y = row[FY * M + l];
  q.z = row[FZ * M + l];
  q.u = row[FU * M + l];
  q.v = row[FV * M + l];
  q.w = row[FW * M + l];
  q.wx = row[FWX * M + l];
  q.wy = row[FWY * M + l];
  q.wz = row[FWZ * M + l];
  q.rad = row[FRAD * M + l];
  q.m = row[FM * M + l];
  q.idx = (int)row[FIDX * M + l];
}

__device__ __forceinline__ void init_state(Query& q) {
  q.matched = 0u;
  q.n_new = 0;
  q.n_gated = 0;
#pragma unroll
  for (int c = 0; c < 6; ++c) q.f[c] = 0.0f;
#pragma unroll
  for (int l = 0; l < L_MAX; ++l) {
    q.tidx[l] = -1;
    q.tdem[l] = -1;
    q.tsx[l] = q.tsy[l] = q.tsz[l] = 0.0f;
    q.nj[l] = q.nd[l] = -1;
  }
}

// one candidate lane k of a shared tile (field f at s[f * TL + k])
__device__ __forceinline__ void lvc_pair(Query& q, const float* s, int TL,
                                         int k, int L, int E,
                                         const float* mat, float dt,
                                         float cutoff) {
  const float jf = s[FIDX * TL + k];
  if (!(jf >= 0.0f)) return;
  const int j = (int)jf;
  if (j == q.idx) return;
  const float xij = q.x - s[FX * TL + k];
  const float yij = q.y - s[FY * TL + k];
  const float zij = q.z - s[FZ * TL + k];
  const float rij = sqrtf(xij * xij + yij * yij + zij * zij);
  if (!(rij <= cutoff)) return;
  const float srad = s[FRAD * TL + k];
  const float overlap = q.rad + srad - rij;
  if (!(rij > 0.0f) || !(overlap > 0.0f)) return;
  q.n_gated += 1;

  const int dem = (int)s[FDEM * TL + k];
  float kn = 0.0f, kt = 0.0f, alpha = 0.0f, mu = 0.0f;
  if (dem >= 0 && dem < E) {
    kn = mat[4 * dem];
    kt = mat[4 * dem + 1];
    alpha = mat[4 * dem + 2];
    mu = mat[4 * dem + 3];
  }

  const float rinv = 1.0f / fmaxf(rij, 1e-30f);
  const float nx = xij * rinv, ny = yij * rinv, nz = zij * rinv;
  const float a_i = q.rad - overlap / 2.0f;
  const float a_j = srad - overlap / 2.0f;
  const float swx = s[FWX * TL + k], swy = s[FWY * TL + k],
              swz = s[FWZ * TL + k];
  const float vi_x = q.u + (q.wy * nz - q.wz * ny) * a_i;
  const float vi_y = q.v + (q.wz * nx - q.wx * nz) * a_i;
  const float vi_z = q.w + (q.wx * ny - q.wy * nx) * a_i;
  const float vj_x = s[FU * TL + k] + (-swy * nz + swz * ny) * a_j;
  const float vj_y = s[FV * TL + k] + (-swz * nx + swx * nz) * a_j;
  const float vj_z = s[FW * TL + k] + (-swx * ny + swy * nx) * a_j;
  const float vij_x = vi_x - vj_x, vij_y = vi_y - vj_y, vij_z = vi_z - vj_z;
  const float vdotn = vij_x * nx + vij_y * ny + vij_z * nz;
  const float vt_x = vij_x - vdotn * nx;
  const float vt_y = vij_y - vdotn * ny;
  const float vt_z = vij_z - vdotn * nz;
  const float sm = s[FM * TL + k];
  const float m_eff = q.m * sm / (q.m + sm);
  const float eta_n = alpha * sqrtf(m_eff);
  const float fn = kn * overlap - eta_n * vdotn;
  const float fn_x = fn * nx, fn_y = fn * ny, fn_z = fn * nz;

  // the table entry of this partner, if any
  int slot = -1;
#pragma unroll
  for (int l = 0; l < L_MAX; ++l)
    if (l < L && slot < 0 && q.tidx[l] == j && q.tdem[l] == dem) slot = l;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
#pragma unroll
  for (int l = 0; l < L_MAX; ++l)
    if (l == slot) {
      sx = q.tsx[l];
      sy = q.tsy[l];
      sz = q.tsz[l];
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
    const float kt_inv = 1.0f / (kt > 0.0f ? kt : 1.0f);
    const float nsx = slip ? -kt_inv * (fn_mu * tx + eta_n * vt_x)
                           : sx + vt_x * dt;
    const float nsy = slip ? -kt_inv * (fn_mu * ty + eta_n * vt_y)
                           : sy + vt_y * dt;
    const float nsz = slip ? -kt_inv * (fn_mu * tz + eta_n * vt_z)
                           : sz + vt_z * dt;
#pragma unroll
    for (int l = 0; l < L_MAX; ++l)
      if (l == slot) {
        q.tsx[l] = nsx;
        q.tsy[l] = nsy;
        q.tsz[l] = nsz;
      }
    q.matched |= 1u << slot;
  } else {
    // a new contact: no tangential force this step, a slot if one frees
    ft_x = ft_y = ft_z = 0.0f;
#pragma unroll
    for (int r = 0; r < L_MAX; ++r)
      if (r == q.n_new) {
        q.nj[r] = j;
        q.nd[r] = dem;
      }
    q.n_new += 1;
  }
  q.f[0] += fn_x + ft_x;
  q.f[1] += fn_y + ft_y;
  q.f[2] += fn_z + ft_z;
  q.f[3] += (ny * ft_z - nz * ft_y) * a_i;
  q.f[4] += (nz * ft_x - nx * ft_z) * a_i;
  q.f[5] += (nx * ft_y - ny * ft_x) * a_i;
}

// after the pass: unmatched slots are free; the r-th new contact takes
// the r-th free slot.  Returns the live entries.
__device__ __forceinline__ int finish(Query& q, int L) {
  int r = 0, cnt = 0;
#pragma unroll
  for (int l = 0; l < L_MAX; ++l) {
    if (l >= L) continue;
    if ((q.matched >> l) & 1u) {
      ++cnt;
      continue;
    }
    int nj = -1, nd = -1;
#pragma unroll
    for (int rr = 0; rr < L_MAX; ++rr)
      if (rr == r && rr < q.n_new) {
        nj = q.nj[rr];
        nd = q.nd[rr];
      }
    q.tidx[l] = nj;
    q.tdem[l] = nd;
    q.tsx[l] = q.tsy[l] = q.tsz[l] = 0.0f;
    if (nj >= 0) ++cnt;
    ++r;
  }
  return cnt;
}

// stage TILE source slots (stencil entries or run slots) of one group:
// entry oo reads pack row slot_of(oo), or marks its lanes empty
template <typename SlotOf>
__device__ __forceinline__ void stage_tile(float* shg, const float* pack,
                                           int nrows, int M, int l,
                                           SlotOf slot_of) {
  const int TL = TILE * M;
  for (int e = l; e < TILE * NF * M; e += M) {
    const int ll = e % M;
    const int t = e / M;
    const int f = t % NF;
    const int oo = t / NF;
    const long long sl = slot_of(oo);
    float v = (f == FIDX) ? -1.0f : 0.0f;
    if (sl >= 0 && sl < nrows) v = pack[(sl * NF + f) * M + ll];
    shg[f * TL + oo * M + ll] = v;
  }
}

__global__ void __launch_bounds__(THREADS) dem_cell_kernel(
    const float* __restrict__ dft, const long long* __restrict__ nbr,
    const int* __restrict__ t_idx, const int* __restrict__ t_dem,
    const float* __restrict__ t_x, const float* __restrict__ t_y,
    const float* __restrict__ t_z, const float* __restrict__ mat,
    float* __restrict__ o_sum, int* __restrict__ o_idx,
    int* __restrict__ o_dem, float* __restrict__ o_spr, int N, int NC, int O,
    int M, int L, int E, float dt, float cutoff) {
  __shared__ float sh[NF * TILE * THREADS + THREADS];
  __shared__ float smat[E_MAX * 4];
  __shared__ int glive[THREADS];
  const int t = threadIdx.x;
  const int g = t / M, l = t % M;
  const int s = blockIdx.x * (THREADS / M) + g;
  const int TL = TILE * M;
  float* shg = sh + g * (NF * TL + 1);
  if (t < E * 4) smat[t] = mat[t];
  if (l == 0) glive[g] = 0;

  Query q;
  init_state(q);
  q.idx = -1;
  if (s < NC) load_query(q, dft + (long long)s * NF * M, M, l);
  const bool live = q.idx >= 0 && q.idx < N;
  if (live) {
    const long long p = q.idx;
#pragma unroll
    for (int k = 0; k < L_MAX; ++k)
      if (k < L) {
        q.tidx[k] = t_idx[p * L + k];
        q.tdem[k] = t_dem[p * L + k];
        q.tsx[k] = t_x[p * L + k];
        q.tsy[k] = t_y[p * L + k];
        q.tsz[k] = t_z[p * L + k];
      }
  }
  __syncthreads();
  if (live) glive[g] = 1;
  if (!__syncthreads_or(live)) return;   // block-uniform
  const bool group_live = glive[g] != 0;

  for (int o0 = 0; o0 < O; o0 += TILE) {
    __syncthreads();   // the previous tile has been consumed
    if (group_live)
      stage_tile(shg, dft, NC, M, l, [&](int oo) -> long long {
        return o0 + oo < O ? nbr[(long long)s * O + o0 + oo] : -1LL;
      });
    __syncthreads();
    if (live)
      for (int k = 0; k < TL; ++k)
        lvc_pair(q, shg, TL, k, L, E, smat, dt, cutoff);
  }
  if (!live) return;

  const int cnt = finish(q, L);
  const long long p = q.idx;
#pragma unroll
  for (int c = 0; c < 6; ++c) o_sum[p * 8 + c] = q.f[c];
  o_sum[p * 8 + 6] = (float)cnt;
  o_sum[p * 8 + 7] = (float)q.n_gated;
#pragma unroll
  for (int k = 0; k < L_MAX; ++k)
    if (k < L) {
      o_idx[p * L + k] = q.tidx[k];
      o_dem[p * L + k] = q.tdem[k];
      o_spr[p * L + k] = q.tsx[k];
      o_spr[((long long)N + p) * L + k] = q.tsy[k];
      o_spr[(2LL * N + p) * L + k] = q.tsz[k];
    }
}

__global__ void __launch_bounds__(THREADS) dem_rowwin_kernel(
    const float* __restrict__ dfs, const float* __restrict__ dft,
    const long long* __restrict__ runs, const long long* __restrict__ run_cnt,
    const float* __restrict__ mat, float* __restrict__ out, int NCW, int R,
    int M, int L, int E, float dt, float cutoff) {
  __shared__ float sh[NF * TILE * THREADS + THREADS];
  __shared__ float smat[E_MAX * 4];
  __shared__ int glive[THREADS];
  const int t = threadIdx.x;
  const int g = t / M, l = t % M;
  const int w = blockIdx.x * (THREADS / M) + g;
  const int TL = TILE * M;
  float* shg = sh + g * (NF * TL + 1);
  if (t < E * 4) smat[t] = mat[t];
  if (l == 0) glive[g] = 0;

  Query q;
  init_state(q);
  q.idx = -1;
  long long rs[R_MAX];
  int rc[R_MAX];
  int T = 0;
#pragma unroll
  for (int r = 0; r < R_MAX; ++r) {
    rs[r] = -1;
    rc[r] = 0;
  }
  if (w < NCW) {
    load_query(q, dfs + (long long)w * NF * M, M, l);
    const float* tab = dft + (long long)w * 5 * L * M;
#pragma unroll
    for (int k = 0; k < L_MAX; ++k)
      if (k < L) {
        q.tidx[k] = (int)tab[(0 * L + k) * M + l];
        q.tdem[k] = (int)tab[(1 * L + k) * M + l];
        q.tsx[k] = tab[(2 * L + k) * M + l];
        q.tsy[k] = tab[(3 * L + k) * M + l];
        q.tsz[k] = tab[(4 * L + k) * M + l];
      }
#pragma unroll
    for (int r = 0; r < R_MAX; ++r)
      if (r < R) {
        rs[r] = runs[(long long)w * R + r];
        rc[r] = (int)max(run_cnt[(long long)w * R + r], 0LL);
        T += rc[r];
      }
  }
  const bool live = q.idx >= 0;
  __syncthreads();
  if (live) glive[g] = 1;
  if (__syncthreads_or(live)) {   // block-uniform
    const bool group_live = glive[g] != 0;
    for (int c0 = 0;; c0 += TILE) {
      // also the barrier after the previous tile's pass
      if (!__syncthreads_or(group_live && c0 < T)) break;
      if (group_live && c0 < T)
        stage_tile(shg, dfs, NCW, M, l, [&](int oo) -> long long {
          // flat run-slot index -> (run, slot), runs in order
          const int c = c0 + oo;
          long long sl = -1;
          int acc = 0;
#pragma unroll
          for (int r = 0; r < R_MAX; ++r) {
            if (sl < 0 && c >= acc && c < acc + rc[r]) sl = rs[r] + (c - acc);
            acc += rc[r];
          }
          return sl;
        });
      __syncthreads();
      if (live && c0 < T)   // a group past its last run slot has no tile
        for (int k = 0; k < TL; ++k)
          lvc_pair(q, shg, TL, k, L, E, smat, dt, cutoff);
    }
  }
  if (w >= NCW) return;

  const int cnt = finish(q, L);
  const int W = 8 + 5 * L;
  float* o = out + ((long long)w * M + l) * W;
#pragma unroll
  for (int c = 0; c < 6; ++c) o[c] = q.f[c];
  o[6] = (float)cnt;
  o[7] = (float)q.n_gated;
#pragma unroll
  for (int k = 0; k < L_MAX; ++k)
    if (k < L) {
      o[8 + k] = (float)q.tidx[k];
      o[8 + L + k] = (float)q.tdem[k];
      o[8 + 2 * L + k] = q.tsx[k];
      o[8 + 3 * L + k] = q.tsy[k];
      o[8 + 4 * L + k] = q.tsz[k];
    }
}

bool bad_shape(int M, int L, int E) {
  return M < 1 || M > THREADS || THREADS % M != 0 || L < 1 || L > L_MAX ||
         E < 0 || E > E_MAX;
}

}  // namespace

extern "C" int dem_cell(const void* dft, const void* nbr, const void* t_idx,
                        const void* t_dem, const void* t_x, const void* t_y,
                        const void* t_z, const void* mat, void* o_sum,
                        void* o_idx, void* o_dem, void* o_spr, int N, int NC,
                        int O, int M, int L, int E, float dt, float cutoff,
                        void* stream) {
  if (bad_shape(M, L, E)) return (int)cudaErrorInvalidValue;
  if (NC == 0 || N == 0) return 0;
  const int G = THREADS / M;
  dem_cell_kernel<<<(NC + G - 1) / G, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)dft, (const long long*)nbr, (const int*)t_idx,
      (const int*)t_dem, (const float*)t_x, (const float*)t_y,
      (const float*)t_z, (const float*)mat, (float*)o_sum, (int*)o_idx,
      (int*)o_dem, (float*)o_spr, N, NC, O, M, L, E, dt, cutoff);
  return (int)cudaGetLastError();
}

extern "C" int dem_rowwin(const void* dfs, const void* dft, const void* runs,
                          const void* run_cnt, const void* mat, void* out,
                          int NCW, int R, int M, int L, int E, float dt,
                          float cutoff, void* stream) {
  if (bad_shape(M, L, E) || R < 1 || R > R_MAX)
    return (int)cudaErrorInvalidValue;
  if (NCW == 0) return 0;
  const int G = THREADS / M;
  dem_rowwin_kernel<<<(NCW + G - 1) / G, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)dfs, (const float*)dft, (const long long*)runs,
      (const long long*)run_cnt, (const float*)mat, (float*)out, NCW, R, M,
      L, E, dt, cutoff);
  return (int)cudaGetLastError();
}
