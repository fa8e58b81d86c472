// The rigid-fluid coupling steps' fluid pair passes on the spill cell grid.
//
// Replaces the TPU kernels of rigid_body_2d_3d_pysph_tpu/ops/pallas_fluid.py
// (the _scaffold / cell_pair_pallas scaffold with five compute bodies).
// The fused kdkf step runs the first two, the kdk and reference orderings
// the split passes:
//
//   fluid_rates_wall      fluid_rates_wall_pallas :364 (B4) -> [NC, M, 7]
//                         arho, ap (fluid queries); uf, vf, wf, sw, p_num
//                         (wall and body queries, the Adami sums)
//   fluid_forces_contact  fluid_forces_contact_pallas :590 (B5, _forces_cols
//                         :494 + pallas_contact._pair_body(union=True))
//                         -> [NC, M, 12 S + 6]: the Mofidi contact columns
//                         in K2's order, then au, av, aw, fx, fy, fz
//   fluid_rates           fluid_rates_pallas :302 (B6a) -> [NC, M, 2],
//                         B4's rates alone, the fluid/boundary and the
//                         FSI-rigid source classes summed apart
//   wall_bc               wall_bc_pallas :460 (B6b) -> [NC, M, 5], B4's
//                         wall sums alone
//   fluid_forces          fluid_forces_pallas :562 (B6c) -> [NC, M, 6],
//                         the forces alone (B5 without its contact part),
//                         with or without the FSI terms
//
// Inputs: the coupling pack dft [NC + 1, 14, M] (x y z u v w m rho h p
// m_fsi rho_fsi p_fsi flags; flags = dem*16 + cfib*8 + static_boundary*4 +
// fluid*2 + rigid, sentinel -16) and the stencil rows nbr [NC, O] (int64,
// NC = no neighbour).  Query slot s is row s of the pack; sources are the
// rows nbr[s][0..O), M lanes each, visited in that order.  Every output row
// is written: a sentinel query lane gets zeros (and the contact init row).
//
// Bound on the card: latency and instruction issue, not bytes.  The pack
// is 56 bytes a lane and every query lane tests O x M candidate lanes,
// about a tenth of them in range.  Design, the same for all five passes:
// one thread per query lane, blocks of 128 threads (8 slots of M = 16),
// each thread scanning its slot's stencil rows in order with every sum in
// a register.  The 16 threads of a slot read the same source word at once
// (a broadcast through the read-only cache), so no shared-memory staging
// is needed; missing stencil entries and out-of-range lanes are skipped.
// The compile-time choices of the TPU kernels (EDAC, rigid bodies present,
// artificial viscosity on, the kernel's dimension) are template
// parameters, not branches per pair.
//
// B5's split of work: the force sums and the contact state of one query
// lane live in the same thread.  The force sums are one scan over the
// stencil (every fluid and rigid query lane); the contact state of entity
// slot s (14 registers, mofidi::Acc) is one further scan per s, made only
// by rigid query lanes, with the accumulation, pick and epilogue of
// csrc/mofidi.cuh that K2 uses.  One thread per lane keeps one summation
// order per sum (stencil entry, then lane, as the plain version) and
// keeps the fluid scan, which is most of the work, on every thread; the
// S contact scans cost only the few rigid lanes (a few per cent of the
// particles), so a thread per (lane, s) as in K2 would leave S - 1 of S
// threads idle during the fluid scan.
//
// Built with --fmad=false, so every per-pair term rounds as the plain
// PyTorch version's does: the contact picks are bit for bit the plain
// version's, the sums differ only in summation order.
#include "mofidi.cuh"

namespace {

enum {
  FX, FY, FZ, FU, FV, FW, FM, FRHO, FH, FP, FMFSI, FRHOFSI, FPFSI, FFLAGS,
  NF
};
constexpr int kThreads = 128;

struct Flags {
  float dem, cfib, sbdry, fluid, rigid;
};

__device__ __forceinline__ Flags decode(float f) {
  Flags d;
  d.dem = floorf(f * (1.0f / 16.0f));
  float r = f - 16.0f * d.dem;
  d.cfib = floorf(r * 0.125f);
  r = r - 8.0f * d.cfib;
  d.sbdry = floorf(r * 0.25f);
  r = r - 4.0f * d.sbdry;
  d.fluid = floorf(r * 0.5f);
  d.rigid = r - 2.0f * d.fluid;
  return d;
}

// one query lane: its row of the pack and its slot's stencil row
struct Query {
  const float* row;    // dft + slot * NF * M (lane l at row[f * M + l])
  const long long* nbr;
  int l;
};

__device__ __forceinline__ float field(const float* row, int f, int M, int l) {
  return __ldg(row + f * M + l);
}

// dW/dr / r of the quintic spline with the guarded 1/r (0 at r = 0), and
// W from the same q and sigma (ops/kernels.py QuinticSpline.w_gradw)
template <bool KDIM2>
__device__ __forceinline__ void quintic_w_gradw(float rij, float h,
                                                float sig_num, float sig_den,
                                                float& w, float& dw) {
  const float q = rij / h;
  const float t3 = fmaxf(3.0f - q, 0.0f);
  const float t2 = fmaxf(2.0f - q, 0.0f);
  const float t1 = fmaxf(1.0f - q, 0.0f);
  const float t3_4 = mofidi::pow4(t3), t2_4 = mofidi::pow4(t2),
              t1_4 = mofidi::pow4(t1);
  const float sig = mofidi::quintic_sigma<KDIM2>(h, sig_num, sig_den);
  w = sig * (t3_4 * t3 - 6.0f * (t2_4 * t2) + 15.0f * (t1_4 * t1));
  const float dval = -5.0f * t3_4 + 30.0f * t2_4 - 75.0f * t1_4;
  const float inv = rij > 1e-12f ? 1.0f / fmaxf(rij, 1e-12f) : 0.0f;
  dw = sig * dval / h * inv;
}

template <bool KDIM2>
__device__ __forceinline__ float quintic_gradw(float rij, float h,
                                               float sig_num, float sig_den) {
  float w, dw;
  quintic_w_gradw<KDIM2>(rij, h, sig_num, sig_den, w, dw);
  return dw;
}

// ---------------------------------------------------------------------------
// B4: rates (fluid queries) and the Adami wall sums (wall and body queries)
// in one sweep; B6a the rates alone, B6b the wall sums alone
// ---------------------------------------------------------------------------

// which columns a rates/wall instance writes
enum { kRatesWall = 0, kRates = 1, kWall = 2 };

template <bool KDIM2, bool EDAC, bool HAS_RIGID, int MODE>
__global__ void rates_wall_kernel(const float* __restrict__ dft,
                                  const long long* __restrict__ nbr,
                                  float* __restrict__ out, int NC, int O,
                                  int M, float cutoff, float nu2, float cs2,
                                  float gx, float gy, float gz, float sig_num,
                                  float sig_den) {
  constexpr bool RATES = MODE != kWall, WALL = MODE != kRates;
  // B6a sums the fluid/boundary and the FSI-rigid source classes apart
  // (pallas_fluid.py:348-351), B4 in one term (:423-433)
  constexpr bool SPLIT = MODE == kRates && HAS_RIGID;
  constexpr int W = MODE == kRatesWall ? 7 : (MODE == kRates ? 2 : 5);
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long slot = g / M;
  const int l = (int)(g - slot * M);
  if (slot >= NC) return;
  const float* q = dft + slot * NF * M;
  const Flags qf = decode(field(q, FFLAGS, M, l));
  const bool dest_fluid = RATES && qf.fluid == 1.0f;
  const bool dest_solid = WALL && (qf.sbdry == 1.0f || qf.rigid == 1.0f);

  // arho2, ap2: the FSI-rigid class of B6a
  float arho = 0.f, ap = 0.f, arho2 = 0.f, ap2 = 0.f;
  float uf = 0.f, vf = 0.f, wf = 0.f, sw = 0.f, pn = 0.f;
  if (dest_fluid || dest_solid) {
    const float qx = field(q, FX, M, l), qy = field(q, FY, M, l),
                qz = field(q, FZ, M, l);
    const float qu = field(q, FU, M, l), qv = field(q, FV, M, l),
                qw = field(q, FW, M, l);
    const float mi = field(q, FM, M, l), rhoi = field(q, FRHO, M, l);
    const float qh = field(q, FH, M, l), pi = field(q, FP, M, l);
    const float inv_m = 1.0f / fmaxf(mi, 1e-30f);
    const float Vi = mi / rhoi;
    for (int o = 0; o < O; ++o) {
      const long long sl = nbr[slot * O + o];
      if (sl < 0 || sl >= NC) continue;   // no neighbour: the sentinel row
      const float* s = dft + sl * NF * M;
      for (int k = 0; k < M; ++k) {
        const float xij = qx - field(s, FX, M, k);
        const float yij = qy - field(s, FY, M, k);
        const float zij = qz - field(s, FZ, M, k);
        const float r2 = xij * xij + yij * yij + zij * zij;
        const float rij = sqrtf(r2);
        if (!(rij <= cutoff)) continue;
        const Flags sf = decode(field(s, FFLAGS, M, k));
        const bool src_fluid = sf.fluid == 1.0f;
        const bool src_flbd = src_fluid || sf.sbdry == 1.0f;
        const bool src_rigid = sf.rigid == 1.0f;
        const bool rates =
            dest_fluid && (src_flbd || (HAS_RIGID && src_rigid));
        const bool wall = dest_solid && src_fluid;
        if (!(rates || wall)) continue;
        const float hij = 0.5f * (qh + field(s, FH, M, k));
        float w, dw;
        quintic_w_gradw<KDIM2>(rij, hij, sig_num, sig_den, w, dw);
        if (rates) {
          const bool fsi = HAS_RIGID && src_rigid;
          const float mj = field(s, fsi ? FMFSI : FM, M, k);
          const float rhoj = field(s, fsi ? FRHOFSI : FRHO, M, k);
          const float dwx = dw * xij, dwy = dw * yij, dwz = dw * zij;
          const float vdotdw = (qu - field(s, FU, M, k)) * dwx +
                               (qv - field(s, FV, M, k)) * dwy +
                               (qw - field(s, FW, M, k)) * dwz;
          const float da = rhoi * mj / rhoj * vdotdw;
          float dp = 0.f;
          if (EDAC) {
            const float pj = field(s, fsi ? FPFSI : FP, M, k);
            const float xdotdw = xij * dwx + yij * dwy + zij * dwz;
            const float eps = 0.01f * hij * hij;
            const float ap1 = rhoi / rhoj * cs2 * mj * vdotdw;
            const float Vj = mj / rhoj;
            const float etaij = nu2 * (rhoi * rhoj) / (rhoi + rhoj);
            const float tmp = inv_m * (Vi * Vi + Vj * Vj) * etaij * xdotdw /
                              (r2 + eps);
            dp = ap1 + tmp * (pi - pj);
          }
          if (SPLIT && fsi) {
            arho2 += da;
            ap2 += dp;
          } else {
            arho += da;
            ap += dp;
          }
        }
        if (wall) {
          const float gdotx = gx * xij + gy * yij + gz * zij;
          uf += field(s, FU, M, k) * w;
          vf += field(s, FV, M, k) * w;
          wf += field(s, FW, M, k) * w;
          sw += w;
          pn += (field(s, FP, M, k) + field(s, FRHO, M, k) * gdotx) * w;
        }
      }
    }
  }
  float* o = out + (slot * M + l) * W;
  if (RATES) {
    o[0] = SPLIT ? arho + arho2 : arho;
    o[1] = SPLIT ? ap + ap2 : ap;
    o += 2;
  }
  if (WALL) {
    o[0] = uf;
    o[1] = vf;
    o[2] = wf;
    o[3] = sw;
    o[4] = pn;
  }
}

// ---------------------------------------------------------------------------
// B5 / B6c: pressure gradient + artificial viscosity; with FSI (rigid
// bodies present) the FSI source class and the fluid -> rigid force; with
// CONTACT the Mofidi contact columns on the union layout first.  B5 is
// FSI and CONTACT, B6c FSI (kdk and reference orderings) or neither.
// ---------------------------------------------------------------------------

template <bool KDIM2, bool VISC, bool FSI, bool CONTACT>
__global__ void forces_kernel(const float* __restrict__ dft,
                              const long long* __restrict__ nbr,
                              float* __restrict__ out, int NC, int O, int M,
                              int S, float cutoff, float alpha_c0,
                              float init_dist, float sig_num, float sig_den) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long slot = g / M;
  const int l = (int)(g - slot * M);
  if (slot >= NC) return;
  const int W = CONTACT ? 12 * S + 6 : 6;
  float* orow = out + (slot * M + l) * W;
  const float* q = dft + slot * NF * M;
  const Flags qf = decode(field(q, FFLAGS, M, l));
  const bool dest_fluid = qf.fluid == 1.0f;
  const bool dest_rigid = FSI && qf.rigid == 1.0f;
  const float qx = field(q, FX, M, l), qy = field(q, FY, M, l),
              qz = field(q, FZ, M, l);
  const float qh = field(q, FH, M, l);

  // pressure gradient and viscosity sums (separate, as the reference
  // adds the two lane sums), then the fluid -> rigid force
  float au = 0.f, av = 0.f, aw = 0.f, vu = 0.f, vv = 0.f, vw = 0.f;
  float fx = 0.f, fy = 0.f, fz = 0.f;
  if (dest_fluid || dest_rigid) {
    const float qu = field(q, FU, M, l), qv = field(q, FV, M, l),
                qw = field(q, FW, M, l);
    const float rhoi = field(q, FRHO, M, l), pi = field(q, FP, M, l);
    const float pi_term = pi / (rhoi * rhoi);
    float mfsi_i = 0.f, pfsi_term = 0.f;
    if (FSI) {
      const float rhofsi_i = field(q, FRHOFSI, M, l);
      mfsi_i = field(q, FMFSI, M, l);
      pfsi_term = field(q, FPFSI, M, l) / fmaxf(rhofsi_i * rhofsi_i, 1e-30f);
    }
    for (int o = 0; o < O; ++o) {
      const long long sl = nbr[slot * O + o];
      if (sl < 0 || sl >= NC) continue;
      const float* s = dft + sl * NF * M;
      for (int k = 0; k < M; ++k) {
        const float xij = qx - field(s, FX, M, k);
        const float yij = qy - field(s, FY, M, k);
        const float zij = qz - field(s, FZ, M, k);
        const float r2 = xij * xij + yij * yij + zij * zij;
        const float rij = sqrtf(r2);
        if (!(rij <= cutoff)) continue;
        const Flags sf = decode(field(s, FFLAGS, M, k));
        const bool src_fluid = sf.fluid == 1.0f;
        const bool src_flbd = src_fluid || sf.sbdry == 1.0f;
        const bool src_rigid = FSI && sf.rigid == 1.0f;
        if (!(src_flbd || src_rigid)) continue;
        const float hij = 0.5f * (qh + field(s, FH, M, k));
        const float dw = quintic_gradw<KDIM2>(rij, hij, sig_num, sig_den);
        const float dwx = dw * xij, dwy = dw * yij, dwz = dw * zij;
        const float mj = field(s, FM, M, k);
        const float rhoj = field(s, FRHO, M, k);
        const float pj = field(s, FP, M, k);
        if (dest_fluid) {
          const float mj_e = src_rigid ? field(s, FMFSI, M, k) : mj;
          const float rhoj_e = src_rigid ? field(s, FRHOFSI, M, k) : rhoj;
          const float pj_e = src_rigid ? field(s, FPFSI, M, k) : pj;
          const float pij = pi_term + pj_e / (rhoj_e * rhoj_e);
          const float t = -mj_e * pij;
          au += t * dwx;
          av += t * dwy;
          aw += t * dwz;
          if (VISC && src_fluid) {
            const float vdotx = (qu - field(s, FU, M, k)) * xij +
                                (qv - field(s, FV, M, k)) * yij +
                                (qw - field(s, FW, M, k)) * zij;
            if (vdotx < 0.0f) {
              const float eps = 0.01f * hij * hij;
              const float muij = hij * vdotx / (r2 + eps);
              const float piij =
                  alpha_c0 * muij * mj * (2.0f / (rhoi + rhoj));
              vu += -piij * dwx;
              vv += -piij * dwy;
              vw += -piij * dwz;
            }
          }
        }
        if (dest_rigid && src_fluid) {
          const float t1 = pj / (rhoj * rhoj) + pfsi_term;
          const float fac = -mfsi_i * mj * t1;
          fx += fac * dwx;
          fy += fac * dwy;
          fz += fac * dwz;
        }
      }
    }
  }
  float* of = orow + (CONTACT ? 12 * S : 0);
  of[0] = au + vu;
  of[1] = av + vv;
  of[2] = aw + vw;
  of[3] = fx;
  of[4] = fy;
  of[5] = fz;

  if (CONTACT) {
    // gate: contact-boundary (cfib), non-fluid source of entity s != the
    // query's dem; rigid query; r <= cutoff.  V_q = m / rho (the patched
    // rho column; rigid lanes are never patched)
    const float qvol = field(q, FM, M, l) / field(q, FRHO, M, l);
    for (int s_id = 0; s_id < S; ++s_id) {
      const float sf_id = (float)s_id;
      mofidi::Acc acc;
      acc.init();
      if (qf.rigid == 1.0f && qf.dem != sf_id) {
        for (int o = 0; o < O; ++o) {
          const long long sl = nbr[slot * O + o];
          if (sl < 0 || sl >= NC) continue;
          const float* s = dft + sl * NF * M;
          for (int k = 0; k < M; ++k) {
            const Flags sf = decode(field(s, FFLAGS, M, k));
            if (!(sf.cfib == 1.0f && sf.fluid == 0.0f && sf.dem == sf_id))
              continue;
            const float sx = field(s, FX, M, k), sy = field(s, FY, M, k),
                        sz = field(s, FZ, M, k);
            const float xij = qx - sx;
            const float yij = qy - sy;
            const float zij = qz - sz;
            float r2 = xij * xij + yij * yij;
            r2 = r2 + zij * zij;
            const float rij = sqrtf(r2);
            if (!(rij <= cutoff)) continue;
            const float hij = 0.5f * (qh + field(s, FH, M, k));
            const float wij =
                mofidi::quintic_w<KDIM2>(rij, hij, sig_num, sig_den);
            acc.add<false>(xij, yij, zij, rij, wij, qvol, sx, sy, sz,
                           field(s, FU, M, k), field(s, FV, M, k),
                           field(s, FW, M, k));
          }
        }
      }
      acc.store(orow + s_id, S, init_dist);
    }
  }
}

inline unsigned blocks_for(long long lanes) {
  return (unsigned)((lanes + kThreads - 1) / kThreads);
}

template <int MODE>
int rates_wall_entry(const void* dft, const void* nbr, void* out, int NC,
                     int O, int M, int kdim2, int edac, int has_rigid,
                     float cutoff, float nu2, float cs2, float gx, float gy,
                     float gz, float sig_num, float sig_den, void* stream) {
  if (NC < 0 || O < 1 || M < 1) return (int)cudaErrorInvalidValue;
  if (NC == 0) return 0;
  const auto* d = (const float*)dft;
  const auto* nb = (const long long*)nbr;
  auto* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned nblk = blocks_for((long long)NC * M);
  const int sel = (kdim2 ? 4 : 0) + (edac ? 2 : 0) + (has_rigid ? 1 : 0);
#define RW(K, E, H)                                                        \
  rates_wall_kernel<K, E, H, MODE><<<nblk, kThreads, 0, st>>>(             \
      d, nb, o, NC, O, M, cutoff, nu2, cs2, gx, gy, gz, sig_num, sig_den)
  switch (sel) {
    case 0: RW(false, false, false); break;
    case 1: RW(false, false, true); break;
    case 2: RW(false, true, false); break;
    case 3: RW(false, true, true); break;
    case 4: RW(true, false, false); break;
    case 5: RW(true, false, true); break;
    case 6: RW(true, true, false); break;
    default: RW(true, true, true); break;
  }
#undef RW
  return (int)cudaGetLastError();
}

template <bool KDIM2, bool VISC, bool FSI, bool CONTACT>
void launch_forces(const float* dft, const long long* nbr, float* out, int NC,
                   int O, int M, int S, float cutoff, float alpha_c0,
                   float init_dist, float sig_num, float sig_den,
                   cudaStream_t st) {
  forces_kernel<KDIM2, VISC, FSI, CONTACT>
      <<<blocks_for((long long)NC * M), kThreads, 0, st>>>(
          dft, nbr, out, NC, O, M, S, cutoff, alpha_c0, init_dist, sig_num,
          sig_den);
}

// runtime flags -> the template instance
template <bool FSI, bool CONTACT>
int forces_entry(const void* dft, const void* nbr, void* out, int NC, int O,
                 int M, int S, int kdim2, int visc, float cutoff,
                 float alpha_c0, float init_dist, float sig_num,
                 float sig_den, void* stream) {
  if (NC < 0 || O < 1 || M < 1 || (CONTACT && S < 1))
    return (int)cudaErrorInvalidValue;
  if (NC == 0) return 0;
  const auto* d = (const float*)dft;
  const auto* nb = (const long long*)nbr;
  auto* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
#define FC(K, V)                                                            \
  launch_forces<K, V, FSI, CONTACT>(d, nb, o, NC, O, M, S, cutoff,         \
                                    alpha_c0, init_dist, sig_num, sig_den, \
                                    st)
  switch ((kdim2 ? 2 : 0) + (visc ? 1 : 0)) {
    case 0: FC(false, false); break;
    case 1: FC(false, true); break;
    case 2: FC(true, false); break;
    default: FC(true, true); break;
  }
#undef FC
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fluid_rates_wall(const void* dft, const void* nbr, void* out,
                                int NC, int O, int M, int kdim2, int edac,
                                int has_rigid, float cutoff, float nu2,
                                float cs2, float gx, float gy, float gz,
                                float sig_num, float sig_den, void* stream) {
  return rates_wall_entry<kRatesWall>(dft, nbr, out, NC, O, M, kdim2, edac,
                                      has_rigid, cutoff, nu2, cs2, gx, gy, gz,
                                      sig_num, sig_den, stream);
}

extern "C" int fluid_rates(const void* dft, const void* nbr, void* out,
                           int NC, int O, int M, int kdim2, int edac,
                           int has_rigid, float cutoff, float nu2, float cs2,
                           float sig_num, float sig_den, void* stream) {
  return rates_wall_entry<kRates>(dft, nbr, out, NC, O, M, kdim2, edac,
                                  has_rigid, cutoff, nu2, cs2, 0.0f, 0.0f,
                                  0.0f, sig_num, sig_den, stream);
}

// the wall sums do not depend on EDAC or the rigid source class: one
// instance per kernel dimension
extern "C" int wall_bc(const void* dft, const void* nbr, void* out, int NC,
                       int O, int M, int kdim2, float cutoff, float gx,
                       float gy, float gz, float sig_num, float sig_den,
                       void* stream) {
  if (NC < 0 || O < 1 || M < 1) return (int)cudaErrorInvalidValue;
  if (NC == 0) return 0;
  const auto* d = (const float*)dft;
  const auto* nb = (const long long*)nbr;
  auto* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned nblk = blocks_for((long long)NC * M);
  if (kdim2)
    rates_wall_kernel<true, false, false, kWall><<<nblk, kThreads, 0, st>>>(
        d, nb, o, NC, O, M, cutoff, 0.0f, 0.0f, gx, gy, gz, sig_num,
        sig_den);
  else
    rates_wall_kernel<false, false, false, kWall><<<nblk, kThreads, 0, st>>>(
        d, nb, o, NC, O, M, cutoff, 0.0f, 0.0f, gx, gy, gz, sig_num,
        sig_den);
  return (int)cudaGetLastError();
}

extern "C" int fluid_forces(const void* dft, const void* nbr, void* out,
                            int NC, int O, int M, int kdim2, int visc,
                            int has_rigid, float cutoff, float alpha_c0,
                            float sig_num, float sig_den, void* stream) {
  if (has_rigid)
    return forces_entry<true, false>(dft, nbr, out, NC, O, M, 0, kdim2, visc,
                                     cutoff, alpha_c0, 0.0f, sig_num, sig_den,
                                     stream);
  return forces_entry<false, false>(dft, nbr, out, NC, O, M, 0, kdim2, visc,
                                    cutoff, alpha_c0, 0.0f, sig_num, sig_den,
                                    stream);
}

extern "C" int fluid_forces_contact(const void* dft, const void* nbr,
                                    void* out, int NC, int O, int M, int S,
                                    int kdim2, int visc, float cutoff,
                                    float alpha_c0, float init_dist,
                                    float sig_num, float sig_den,
                                    void* stream) {
  return forces_entry<true, true>(dft, nbr, out, NC, O, M, S, kdim2, visc,
                                  cutoff, alpha_c0, init_dist, sig_num,
                                  sig_den, stream);
}
