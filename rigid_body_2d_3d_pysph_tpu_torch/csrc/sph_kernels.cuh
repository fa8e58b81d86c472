// The six SPH smoothing kernels of ops/kernels.py as device code, for the
// two sources that evaluate one: csrc/contact.cu (W in the Mofidi sums)
// and csrc/fluid.cu (W, dW/dr / r, or both, in the five fluid passes).
//
// A library is built for one kernel: -DRB_SPH_KERNEL=<id> (the
// Kernel.device_id of ops/kernels.py; 0, the quintic spline, when the
// macro is not given) selects it at compile time, and sph::w, sph::gradw
// and sph::w_gradw below forward to it.  So an instance carries the pair
// bodies of its kernel only: no branch per pair, no register the other
// kernels would need.  The entry points take the id of the kernel their
// caller means and refuse another (kId).
//
// Each kernel follows the chain of its ops/kernels.py class: q = r / h,
// the clamps (_pos), the integer powers as the chains t^3 = t (t t),
// t^4 = (t t)(t t), t^5 = t t^4, t^6 = t^2 (t^2 t^2), the cubic's
// q <= 1 select, the Gaussians' q <= 3 support (_within), then
// sigma * value; gradw = (dW/dq / h) * the guarded 1/r of
// Kernel.gradw_scalar.  sigma(h) = num / (den h^dim) from the wrapper's
// (num, den) = Kernel.sigma_constants(); PyTorch evaluates num / x as
// (1 / x) * num, and so do the non-quintic kernels here, while the
// quintic keeps the single division its kernels have always taken.
// Built with --fmad=false (as both sources are), W and dW/dr / r round as
// the plain versions' do on the card, but for the Gaussians' expf (the
// function torch.exp runs on float32 CUDA tensors, compared within the
// sums' tolerance).
#pragma once

#include <cuda_runtime.h>

#ifndef RB_SPH_KERNEL
#define RB_SPH_KERNEL 0
#endif

namespace sph {

__device__ __forceinline__ float pow2(float t) { return t * t; }
__device__ __forceinline__ float pow3(float t) { return t * pow2(t); }

__device__ __forceinline__ float pow4(float t) {
  const float t2 = t * t;
  return t2 * t2;
}

__device__ __forceinline__ float pow5(float t) { return t * pow4(t); }

__device__ __forceinline__ float pow6(float t) {
  const float t2 = t * t;
  return t2 * (t2 * t2);
}

// Kernel.gradw_scalar's guarded 1/r (0 at r = 0)
__device__ __forceinline__ float guarded_inv(float r) {
  return r > 1e-12f ? 1.0f / fmaxf(r, 1e-12f) : 0.0f;
}

// num / (den h h [h]) as ops/kernels.py evaluates it: (1 / x) * num
// (KDIM2 is the kernel's dimension, not the geometry's)
template <bool KDIM2>
__device__ __forceinline__ float sigma(float h, float num, float den) {
  return (1.0f / (KDIM2 ? den * h * h : den * h * h * h)) * num;
}

// gradw and w_gradw from a kernel's w and dwdq (Kernel.gradw_scalar and
// Kernel.w_gradw: two evaluations from the same q)
template <class K>
struct FromDwdq {
  template <bool KDIM2>
  static __device__ __forceinline__ float gradw(float r, float h, float num,
                                                float den) {
    return K::template dwdq<KDIM2>(r, h, num, den) / h * guarded_inv(r);
  }

  template <bool KDIM2>
  static __device__ __forceinline__ void w_gradw(float r, float h, float num,
                                                 float den, float& w,
                                                 float& dw) {
    w = K::template w<KDIM2>(r, h, num, den);
    dw = gradw<KDIM2>(r, h, num, den);
  }
};

// QuinticSpline, support 3h: the code its kernels have always run
// (sigma by one division; w_gradw shares q, sigma and the 4th powers)
struct Quintic {
  template <bool KDIM2>
  static __device__ __forceinline__ float sig(float h, float num,
                                              float den) {
    return KDIM2 ? num / (den * h * h) : num / (den * h * h * h);
  }

  template <bool KDIM2>
  static __device__ __forceinline__ float w(float rij, float h, float num,
                                            float den) {
    const float q = rij / h;
    const float t3 = fmaxf(3.0f - q, 0.0f);
    const float t2 = fmaxf(2.0f - q, 0.0f);
    const float t1 = fmaxf(1.0f - q, 0.0f);
    const float val = pow5(t3) - 6.0f * pow5(t2) + 15.0f * pow5(t1);
    return sig<KDIM2>(h, num, den) * val;
  }

  template <bool KDIM2>
  static __device__ __forceinline__ void w_gradw(float rij, float h,
                                                 float num, float den,
                                                 float& w, float& dw) {
    const float q = rij / h;
    const float t3 = fmaxf(3.0f - q, 0.0f);
    const float t2 = fmaxf(2.0f - q, 0.0f);
    const float t1 = fmaxf(1.0f - q, 0.0f);
    const float t3_4 = pow4(t3), t2_4 = pow4(t2), t1_4 = pow4(t1);
    const float s = sig<KDIM2>(h, num, den);
    w = s * (t3_4 * t3 - 6.0f * (t2_4 * t2) + 15.0f * (t1_4 * t1));
    const float dval = -5.0f * t3_4 + 30.0f * t2_4 - 75.0f * t1_4;
    const float inv = rij > 1e-12f ? 1.0f / fmaxf(rij, 1e-12f) : 0.0f;
    dw = s * dval / h * inv;
  }

  template <bool KDIM2>
  static __device__ __forceinline__ float gradw(float rij, float h,
                                                float num, float den) {
    float w, dw;
    w_gradw<KDIM2>(rij, h, num, den, w, dw);
    return dw;
  }
};

// CubicSpline, support 2h
struct Cubic : FromDwdq<Cubic> {
  template <bool KDIM2>
  static __device__ __forceinline__ float w(float r, float h, float num,
                                            float den) {
    const float q = r / h;
    const float inner = 1.0f - 1.5f * q * q * (1.0f - 0.5f * q);
    const float outer = 0.25f * pow3(fmaxf(2.0f - q, 0.0f));
    return sigma<KDIM2>(h, num, den) * (q <= 1.0f ? inner : outer);
  }

  template <bool KDIM2>
  static __device__ __forceinline__ float dwdq(float r, float h, float num,
                                               float den) {
    const float q = r / h;
    const float inner = -3.0f * q + 2.25f * q * q;
    const float outer = -0.75f * pow2(fmaxf(2.0f - q, 0.0f));
    return sigma<KDIM2>(h, num, den) * (q <= 1.0f ? inner : outer);
  }
};

// WendlandQuintic (C2), support 2h
struct Wendland : FromDwdq<Wendland> {
  template <bool KDIM2>
  static __device__ __forceinline__ float w(float r, float h, float num,
                                            float den) {
    const float q = r / h;
    const float t = fmaxf(1.0f - 0.5f * q, 0.0f);
    return sigma<KDIM2>(h, num, den) * pow4(t) * (2.0f * q + 1.0f);
  }

  template <bool KDIM2>
  static __device__ __forceinline__ float dwdq(float r, float h, float num,
                                               float den) {
    const float q = r / h;
    const float t = fmaxf(1.0f - 0.5f * q, 0.0f);
    return sigma<KDIM2>(h, num, den) * (-5.0f * q) * pow3(t);
  }
};

// WendlandQuinticC4, support 2h; the fractions rounded from double, as
// Python hands them to float32 tensors
struct WendlandC4 : FromDwdq<WendlandC4> {
  template <bool KDIM2>
  static __device__ __forceinline__ float w(float r, float h, float num,
                                            float den) {
    const float q = r / h;
    const float t = fmaxf(1.0f - 0.5f * q, 0.0f);
    constexpr float c = (float)(35.0 / 12.0);
    return sigma<KDIM2>(h, num, den) * pow6(t) *
           (c * q * q + 3.0f * q + 1.0f);
  }

  template <bool KDIM2>
  static __device__ __forceinline__ float dwdq(float r, float h, float num,
                                               float den) {
    const float q = r / h;
    const float t = fmaxf(1.0f - 0.5f * q, 0.0f);
    constexpr float c = (float)(-14.0 / 3.0);
    return sigma<KDIM2>(h, num, den) * c * q * (1.0f + 2.5f * q) * pow5(t);
  }
};

// the Gaussians' sigma: h^dim as the chain h (h h)
template <bool KDIM2>
__device__ __forceinline__ float gauss_sigma(float h, float num, float den) {
  return (1.0f / (den * (KDIM2 ? h * h : h * (h * h)))) * num;
}

// Gaussian, support 3h
struct Gaussian : FromDwdq<Gaussian> {
  template <bool KDIM2>
  static __device__ __forceinline__ float w(float r, float h, float num,
                                            float den) {
    const float q = r / h;
    const float val = gauss_sigma<KDIM2>(h, num, den) * expf(-q * q);
    return q <= 3.0f ? val : 0.0f;
  }

  template <bool KDIM2>
  static __device__ __forceinline__ float dwdq(float r, float h, float num,
                                               float den) {
    const float q = r / h;
    const float val =
        gauss_sigma<KDIM2>(h, num, den) * (-2.0f * q) * expf(-q * q);
    return q <= 3.0f ? val : 0.0f;
  }
};

// SuperGaussian, support 3h; d / 2 + 1 and d / 2 + 2 of the kernel's
// dimension d
struct SuperGaussian : FromDwdq<SuperGaussian> {
  template <bool KDIM2>
  static __device__ __forceinline__ float w(float r, float h, float num,
                                            float den) {
    const float q = r / h;
    const float val = gauss_sigma<KDIM2>(h, num, den) * expf(-q * q) *
                      ((KDIM2 ? 2.0f : 2.5f) - q * q);
    return q <= 3.0f ? val : 0.0f;
  }

  template <bool KDIM2>
  static __device__ __forceinline__ float dwdq(float r, float h, float num,
                                               float den) {
    const float q = r / h;
    const float val =
        expf(-q * q) * (-2.0f * q) * ((KDIM2 ? 3.0f : 3.5f) - q * q);
    const float out = gauss_sigma<KDIM2>(h, num, den) * val;
    return q <= 3.0f ? out : 0.0f;
  }
};

#if RB_SPH_KERNEL == 0
using Selected = Quintic;
#elif RB_SPH_KERNEL == 1
using Selected = Cubic;
#elif RB_SPH_KERNEL == 2
using Selected = Wendland;
#elif RB_SPH_KERNEL == 3
using Selected = WendlandC4;
#elif RB_SPH_KERNEL == 4
using Selected = Gaussian;
#elif RB_SPH_KERNEL == 5
using Selected = SuperGaussian;
#else
#error "RB_SPH_KERNEL: an id of ops/kernels.py KERNELS (0..5)"
#endif

// the id this library was built for (the entry points refuse another)
constexpr int kId = RB_SPH_KERNEL;

// W of the selected kernel
template <bool KDIM2>
__device__ __forceinline__ float w(float r, float h, float num, float den) {
  return Selected::template w<KDIM2>(r, h, num, den);
}

// dW/dr / r with the guarded 1/r (0 at r = 0)
template <bool KDIM2>
__device__ __forceinline__ float gradw(float r, float h, float num,
                                       float den) {
  return Selected::template gradw<KDIM2>(r, h, num, den);
}

// both (Kernel.w_gradw)
template <bool KDIM2>
__device__ __forceinline__ void w_gradw(float r, float h, float num,
                                        float den, float& w, float& dw) {
  Selected::template w_gradw<KDIM2>(r, h, num, den, w, dw);
}

}  // namespace sph
