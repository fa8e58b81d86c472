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
// sorted value read once, so the kernel moves about 4 x (NC + 1) x F x M
// bytes out and 4 x F x N in: at the 2D main paths' ~100k particles a few
// to 20 MB, a few microseconds of HBM time.  Design: the index work is
// done per slot, not per word.  A thread owns V lanes of one slot (V = 4
// when M and the output allow 16-byte stores, else 1): a block is G = M /
// V lane groups (threadIdx.x) times 256 / G slots (threadIdx.y), so no
// division is left in the kernel.  Each thread reads cnt[s] and base[s]
// once and loops over the F fields: V loads of the sorted rows (the
// lanes of a slot, and neighbouring slots, are neighbouring rows) and one
// store of its V output words (a slot's row of a field is M contiguous
// words), offsets in 32 bits whenever F N and (NC + 1) F M fit.  The TPU
// kernel's one-hot MXU placement, 128-lane padding and DMA double buffer
// have no counterpart here: a copy is a copy.
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int V, typename Idx>
__global__ void __launch_bounds__(kThreads)
    pack_expand_kernel(const float* __restrict__ sorted,
                       const long long* __restrict__ base,
                       const long long* __restrict__ cnt,
                       const float* __restrict__ sent,
                       float* __restrict__ out, int N, int NC, int F, int M) {
  const int s = blockIdx.x * blockDim.y + threadIdx.y;
  if (s > NC) return;
  const int l0 = threadIdx.x * V;            // this thread's first lane
  int c = 0;                                 // live lanes of the slot
  Idx b = 0;
  if (s < NC) {
    const long long cs = __ldg(cnt + s);
    c = cs < M ? (int)cs : M;
    b = (Idx)__ldg(base + s);
  }
  const float* src = sorted + b + l0;
  float* dst = out + (Idx)s * F * M + l0;
#pragma unroll 4
  for (int f = 0; f < F; ++f) {
    const float sv = __ldg(sent + f);
    float v[V];
#pragma unroll
    for (int j = 0; j < V; ++j)
      v[j] = l0 + j < c ? __ldg(src + (Idx)f * N + j) : sv;
    if constexpr (V == 4)
      *reinterpret_cast<float4*>(dst + (Idx)f * M) =
          make_float4(v[0], v[1], v[2], v[3]);
    else
      dst[(Idx)f * M] = v[0];
  }
}

template <int V, typename Idx>
void launch(const float* sorted, const long long* base, const long long* cnt,
            const float* sent, float* out, int N, int NC, int F, int M,
            cudaStream_t st) {
  const int groups = M / V;
  const int slots = kThreads / groups > 0 ? kThreads / groups : 1;
  const unsigned blocks = (unsigned)((NC + 1 + slots - 1) / slots);
  pack_expand_kernel<V, Idx><<<blocks, dim3(groups, slots), 0, st>>>(
      sorted, base, cnt, sent, out, N, NC, F, M);
}

}  // namespace

extern "C" int pack_expand(const void* sorted, const void* base,
                           const void* cnt, const void* sent, void* out,
                           int N, int NC, int F, int M, void* stream) {
  if (N < 0 || NC < 0 || F < 0 || M < 1 || M > 1024)
    return (int)cudaErrorInvalidValue;
  if (F == 0) return 0;
  const auto* so = (const float*)sorted;
  const auto* ba = (const long long*)base;
  const auto* cn = (const long long*)cnt;
  const auto* se = (const float*)sent;
  auto* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  // 16-byte stores when a slot's row of a field is whole float4s
  const bool by4 =
      M % 4 == 0 && (reinterpret_cast<unsigned long long>(out) & 15ull) == 0;
  // 32-bit offsets when every index into sorted and out fits
  const bool small = (long long)F * N + M <= INT_MAX &&
                     (long long)(NC + 1) * F * M <= INT_MAX;
  if (by4 && small) launch<4, int>(so, ba, cn, se, o, N, NC, F, M, st);
  else if (by4) launch<4, long long>(so, ba, cn, se, o, N, NC, F, M, st);
  else if (small) launch<1, int>(so, ba, cn, se, o, N, NC, F, M, st);
  else launch<1, long long>(so, ba, cn, se, o, N, NC, F, M, st);
  return (int)cudaGetLastError();
}
