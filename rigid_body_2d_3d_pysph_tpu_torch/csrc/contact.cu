// Mofidi contact sums, closest-source pick and epilogue per query lane.
//
// Replaces the TPU kernel rigid_body_2d_3d_pysph_tpu/ops/pallas_contact.py
// (_kernel + _pair_body, wrapper contact_sums_pallas; the compact
// pipeline contact_pipeline_compact_pallas drives it).  For query slot b
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
// contact distance, closest distance, picked source x/y/z/u/v/w.
// The gate is: source on the contact boundary, not fluid, of another dem
// entity than the query; rigid query; r <= cutoff.  Pack fields: 2D
// x y u v vol h flags (F = 7), 3D x y z u v w vol h flags (F = 9); the
// flags word is dem*8 + boundary*4 + fluid*2 + rigid (the sentinel -8
// decodes to dem -1).  qslot [NI] and nbr [NI, O] are int64, the grid
// build's own index type.
//
// Bound on the card: latency and instruction issue, not bytes.  A block
// reads O x M x F floats (a few KB in 2D, ~100 KB in 3D) and does
// M x O x M pair tests, few of them gated; the main path launches it on
// the few hundred slots the interest cull keeps.  The coupling steps' cell
// pipeline launches it on every slot, most of them without a rigid lane;
// its instance (skip_idle) lets such a block write the init row and
// return, and the culled path's instance has no such test.  Design: one
// block per query slot, one thread per (query lane, entity slot), so
// every running sum and the (min r, lane) pair sit in registers with no
// cross-thread reduction, and the scan in ascending lane order with a strict "<"
// gives the lowest lane on a tie.  Source lanes come through shared
// memory in tiles of TILE stencil entries (all threads read the same
// word at once: a broadcast, no bank conflicts), with their flags
// decoded once at load.  Picks are copies of the shared-memory words,
// so they are exact; nothing goes through a matrix unit.  The quintic
// kernel, the per-pair accumulation and the epilogue are csrc/mofidi.cuh,
// shared with the fused forces + contact kernel of csrc/fluid.cu; built
// with --fmad=false so r = sqrt(x*x + y*y) rounds as the plain version's.
#include "mofidi.cuh"

#define TILE 16
#define S_MAX 64

namespace {

__device__ __forceinline__ void decode_flags(float f, float& dem, float& bdry,
                                             float& fluid, float& rigid) {
  dem = floorf(f * 0.125f);
  float r = f - 8.0f * dem;
  bdry = floorf(r * 0.25f);
  r = r - 4.0f * bdry;
  fluid = floorf(r * 0.5f);
  rigid = r - 2.0f * fluid;
}

template <bool TWO_D, bool SKIP_IDLE>
__global__ void contact_sums_kernel(const float* __restrict__ dft,
                                    const long long* __restrict__ qslot,
                                    const long long* __restrict__ nbr,
                                    float* __restrict__ out, int O, int nrows,
                                    int M, int S, float cutoff,
                                    float init_dist, float sig_num,
                                    float sig_den) {
  constexpr int F = TWO_D ? 7 : 9;
  constexpr int FX = 0, FY = 1, FZ = 2;
  constexpr int FU = TWO_D ? 2 : 3, FV = TWO_D ? 3 : 4, FW = 5;
  constexpr int FVOL = TWO_D ? 4 : 6, FH = TWO_D ? 5 : 7;
  constexpr int FFLAGS = TWO_D ? 6 : 8;

  extern __shared__ float smem[];
  const int TL = TILE * M;
  float* sx = smem;
  float* sy = sx + TL;
  float* sz = sy + TL;
  float* su = sz + TL;
  float* sv = su + TL;
  float* sw = sv + TL;
  float* sh = sw + TL;
  float* sd = sh + TL;   // dem of a contact-surface source, else -1

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int l = t / S;
  const int s = t % S;
  const float sf = (float)s;

  const int qs = (int)min(max(qslot[b], 0LL), (long long)(nrows - 1));
  const float* q = dft + (long long)qs * F * M;
  const float qx = q[FX * M + l];
  const float qy = q[FY * M + l];
  const float qz = TWO_D ? 0.0f : q[FZ * M + l];
  const float qvol = q[FVOL * M + l];
  const float qh = q[FH * M + l];
  float q_dem, q_bdry, q_fluid, q_rigid;
  decode_flags(q[FFLAGS * M + l], q_dem, q_bdry, q_fluid, q_rigid);
  const bool active = (q_rigid == 1.0f) && (q_dem != sf);

  mofidi::Acc acc;
  acc.init();
  // SKIP_IDLE (every slot a query): a block with no active thread writes
  // the init row without loading the stencil
  if (SKIP_IDLE && !__syncthreads_or(active)) {
    acc.store(out + ((long long)b * M + l) * (12 * S) + s, S, init_dist);
    return;
  }

  for (int o0 = 0; o0 < O; o0 += TILE) {
    const int nt = min(TILE, O - o0);
    __syncthreads();   // the previous tile has been consumed
    for (int k = t; k < nt * M; k += blockDim.x) {
      const int o = k / M;
      const int ll = k - o * M;
      const int slot = (int)min(max(nbr[(long long)b * O + o0 + o], 0LL),
                               (long long)(nrows - 1));
      const float* src = dft + (long long)slot * F * M;
      sx[k] = src[FX * M + ll];
      sy[k] = src[FY * M + ll];
      sz[k] = TWO_D ? 0.0f : src[FZ * M + ll];
      su[k] = src[FU * M + ll];
      sv[k] = src[FV * M + ll];
      sw[k] = TWO_D ? 0.0f : src[FW * M + ll];
      sh[k] = src[FH * M + ll];
      float d, bd, fl, rg;
      decode_flags(src[FFLAGS * M + ll], d, bd, fl, rg);
      sd[k] = (bd == 1.0f && fl == 0.0f) ? d : -1.0f;
    }
    __syncthreads();
    if (!active) continue;
    for (int k = 0; k < nt * M; ++k) {
      if (sd[k] != sf) continue;
      const float xij = qx - sx[k];
      const float yij = qy - sy[k];
      float r2 = xij * xij + yij * yij;
      float zij = 0.0f;
      if (!TWO_D) {
        zij = qz - sz[k];
        r2 = r2 + zij * zij;
      }
      const float rij = sqrtf(r2);
      if (!(rij <= cutoff)) continue;
      const float hij = 0.5f * (qh + sh[k]);
      const float wij = mofidi::quintic_w<TWO_D>(rij, hij, sig_num, sig_den);
      acc.add<TWO_D>(xij, yij, zij, rij, wij, qvol, sx[k], sy[k], sz[k],
                     su[k], sv[k], sw[k]);
    }
  }

  acc.store(out + ((long long)b * M + l) * (12 * S) + s, S, init_dist);
}

}  // namespace

extern "C" int contact_sums(const void* dft, const void* qslot,
                            const void* nbr, void* out, int NI, int O,
                            int nrows, int M, int S, int two_d,
                            int skip_idle, float cutoff, float init_dist,
                            float sig_num, float sig_den, void* stream) {
  if (S < 1 || S > S_MAX || M < 1 || M * S > 1024 || nrows < 1)
    return (int)cudaErrorInvalidValue;
  if (NI == 0) return 0;
  const size_t smem = (size_t)TILE * M * 8 * sizeof(float);
  const cudaStream_t st = (cudaStream_t)stream;
#define CS(T, K)                                                          \
  contact_sums_kernel<T, K><<<NI, M * S, smem, st>>>(                     \
      (const float*)dft, (const long long*)qslot, (const long long*)nbr, \
      (float*)out, O, nrows, M, S, cutoff, init_dist, sig_num, sig_den)
  switch ((two_d ? 2 : 0) + (skip_idle ? 1 : 0)) {
    case 0: CS(false, false); break;
    case 1: CS(false, true); break;
    case 2: CS(true, false); break;
    default: CS(true, true); break;
  }
#undef CS
  return (int)cudaGetLastError();
}
