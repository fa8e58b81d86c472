// Device code shared by the two kernels that run the Mofidi contact pass:
// csrc/contact.cu (the rigid packs, F = 7 in 2D and 9 in 3D) and the fused
// forces + contact pass of csrc/fluid.cu (the 14-field coupling pack).
// Both take the per-pair Eq. 21/22 accumulation, the closest-source pick
// and the epilogue from here, and W from the library's SPH kernel
// (csrc/sph_kernels.cuh, sph::w), so the two cannot drift apart; each
// kernel keeps its own pack layout, flags word and gate.
//
// Both kernels are built with --fmad=false: r = sqrt(x*x + y*y) and every
// per-pair term round as the plain PyTorch versions' do, so a distance tie
// and every pick come out as the plain version's.
#pragma once

#include <cuda_runtime.h>

#include "sph_kernels.cuh"

namespace mofidi {

constexpr float kBig = 1.0e9f;

// the epilogue of pallas_contact.py:313-328 for one (query lane, entity
// slot): from the running sums a0..a6, the closest distance and the
// picked source's x/y/z/u/v/w, the 12 column blocks (cfn x/y/z, wij sum,
// contact distance, closest distance, picked source x/y/z/u/v/w) at
// o[c * S]
__device__ __forceinline__ void store_row(float* o, int S, float init_dist,
                                          float a0, float a1, float a2,
                                          float a3, float a4, float a5,
                                          float a6, float minr, float px,
                                          float py, float pz, float pu,
                                          float pv, float pw) {
  const bool has = a3 > 1e-12f;
  const float inv_w = has ? 1.0f / fmaxf(a3, 1e-30f) : 0.0f;
  const float mx = a0 * inv_w, my = a1 * inv_w, mz = a2 * inv_w;
  const float mag = sqrtf(mx * mx + my * my + mz * mz);
  const float inv_m = (has && mag > 0.0f) ? 1.0f / fmaxf(mag, 1e-30f) : 0.0f;
  const float cx = mx * inv_m, cy = my * inv_m, cz = mz * inv_m;
  const float num = cx * a4 + cy * a5 + cz * a6;
  const float dist = has ? num / a3 : 0.0f;
  const bool found = minr < init_dist;
  o[0 * S] = cx;
  o[1 * S] = cy;
  o[2 * S] = cz;
  o[3 * S] = a3;
  o[4 * S] = dist;
  o[5 * S] = fminf(minr, init_dist);
  o[6 * S] = found ? px : 0.0f;
  o[7 * S] = found ? py : 0.0f;
  o[8 * S] = found ? pz : 0.0f;
  o[9 * S] = found ? pu : 0.0f;
  o[10 * S] = found ? pv : 0.0f;
  o[11 * S] = found ? pw : 0.0f;
}

// The running state of one (query lane, source-entity slot): the Eq. 22
// sums a0..a2 = sum t1 (xij, yij, zij), t1 = V_q W / r; the Eq. 21 sums
// a3 = sum t2, a4..a6 = sum t2 (xij, yij, zij), t2 = t1 r; and the closest
// gated source so far with its position and velocity.
struct Acc {
  float a0, a1, a2, a3, a4, a5, a6;
  float minr, px, py, pz, pu, pv, pw;

  __device__ __forceinline__ void init() {
    a0 = a1 = a2 = a3 = a4 = a5 = a6 = 0.0f;
    minr = kBig;
    px = py = pz = pu = pv = pw = 0.0f;
  }

  // one gated pair; callers visit sources in ascending stencil lane order,
  // so the strict "<" keeps the lowest lane on a distance tie.  TWO_D
  // geometry leaves the z sums at zero.
  template <bool TWO_D>
  __device__ __forceinline__ void add(float xij, float yij, float zij,
                                      float rij, float wij, float qvol,
                                      float sx, float sy, float sz, float su,
                                      float sv, float sw) {
    const float rinv = 1.0f / fmaxf(rij, 1e-30f);
    const float t1 = qvol * rinv * wij;
    const float t2 = t1 * rij;
    a0 += t1 * xij;
    a1 += t1 * yij;
    a3 += t2;
    a4 += t2 * xij;
    a5 += t2 * yij;
    if (!TWO_D) {
      a2 += t1 * zij;
      a6 += t2 * zij;
    }
    if (rij < minr) {
      minr = rij;
      px = sx;
      py = sy;
      pz = sz;
      pu = su;
      pv = sv;
      pw = sw;
    }
  }

  __device__ __forceinline__ void store(float* o, int S,
                                        float init_dist) const {
    store_row(o, S, init_dist, a0, a1, a2, a3, a4, a5, a6, minr, px, py, pz,
              pu, pv, pw);
  }
};

}  // namespace mofidi
