// Pack expansion: cell-sorted per-particle fields -> dense slot blocks.
//
// Replaces the TPU kernel rigid_body_2d_3d_pysph_tpu/ops/pallas_pack.py
// (_expand_kernel, wrapper expand_dft_pallas).  Slot s covers the sorted
// rows [base[s], base[s] + cnt[s]); lane l of field f of slot s is
//
//     out[s][f][l] = l < cnt[s] ? sorted[f][base[s] + l] : sent[f]
//
// and one extra row NC is all-sentinel (missing stencil entries point
// there).  Layout: out [NC + 1, F, M] f32, sorted [F, N] f32, base and
// cnt [NC] int64 (the grid build's own index type: no narrowing copy).
//
// Bound on the card: bytes.  Each output float is written once and each
// sorted value read once, so the kernel moves about 2 x 4 x (NC+1) x F x
// M bytes; at the 2D main path's ~100k particles that is a few MB, a few
// microseconds of HBM time, well under the launch cost.  Design: a flat
// grid-stride loop over (slot, field, lane) with the lane fastest, so
// neighbouring threads read neighbouring sorted rows and write
// neighbouring output words (both coalesced).  The TPU kernel's one-hot
// MXU placement, 128-lane padding and DMA double buffer have no
// counterpart here: a copy is a copy.
#include <cuda_runtime.h>

__global__ void pack_expand_kernel(const float* __restrict__ sorted,
                                   const long long* __restrict__ base,
                                   const long long* __restrict__ cnt,
                                   const float* __restrict__ sent,
                                   float* __restrict__ out,
                                   int N, int NC, int F, int M) {
  const long long total = (long long)(NC + 1) * F * M;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int l = (int)(i % M);
    const long long t = i / M;
    const int f = (int)(t % F);
    const int s = (int)(t / F);
    float v = sent[f];
    if (s < NC && l < cnt[s]) {
      v = sorted[(long long)f * N + base[s] + l];
    }
    out[i] = v;
  }
}

extern "C" int pack_expand(const void* sorted, const void* base,
                           const void* cnt, const void* sent, void* out,
                           int N, int NC, int F, int M, void* stream) {
  const long long total = (long long)(NC + 1) * F * M;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  pack_expand_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)sorted, (const long long*)base,
      (const long long*)cnt,
      (const float*)sent, (float*)out, N, NC, F, M);
  return (int)cudaGetLastError();
}
