// The methanation BDF2 march's residual rows and Newton-system blocks, one
// pass each, per lane:
//
//   march_rows:   rhs = -F(y_m, y, y_p, yd),  yd = (alpha*y + c)/h,
//   march_blocks: A, B + D*alpha/h, C (the duplicated edge slots folded)
//                 and the same rhs,
//
// where y_m, y_p are y shifted one grid point down and up, the edge rows
// duplicated; F is models/methanation.py::_rows_bl and A, B, C, D its
// closed-form Jacobian blocks (_analytic_full_jac, slots 0-3). y and c are
// (7, NX, nb) float32, rhs (NX, 7, nb) and the blocks (NX, 7, 7, nb): the
// layouts the block-Thomas kernels read. The lane axis is last everywhere.
//
// Replaces: no TPU kernel. The JAX package leaves these expressions to
// XLA, which fuses them. In the port they were some 70 PyTorch
// elementwise kernels per residual and, per Newton system, four
// zero-filled (NX, 7, 7, nb) blocks written one strided entry at a time,
// the D*alpha/h add and three layout copies (ops/dae_fast.py::
// newton_residual and newton_blocks, which stay their plain versions).
//
// What bounds it on the H100: bytes. The arithmetic is elementwise, four
// expf and about 600 fp32 instructions per grid point and lane for the
// blocks, 150 for the rows; a residual reads y and c and writes rhs (3 x
// 7 floats a point), a Newton system writes 3 x 49 + 7 floats a point.
//
// What the design does about it: one thread per lane and segment of kSeg
// grid points (grid.y cuts the NX points into segments). A thread walks
// its segment with a ring of y at three points in registers (y_m, y, y_p),
// loading the point after next while it computes the current one, so each
// value of y is read from device memory once (a segment's two edge points
// twice). Every entry goes out as a coalesced 4-byte store, lane after
// lane; the structural zeros of the blocks are written as zeros, so
// nothing needs filling beforehand. The per-lane conditions and kinetics
// stay in registers. The constants of the model are compile-time
// constants here: the call copies nothing from the host.
//
// Numerics: bit for bit the plain version on the card. Every expression is
// the plain version's PyTorch operations in their order, each rounded to
// float32 on its own: this file is built with -fmad=false (ops/_build.py),
// so no a*b + c fuses into one rounding, as no two PyTorch kernels do.
// Division is IEEE, and sqrtf and expf are the accurate ones (no fast
// math), as in PyTorch's kernels. Three rules of PyTorch's are kept: a
// tensor divided by a Python scalar is the tensor times the scalar's
// reciprocal, taken in double and rounded to float32 (so the host passes
// 1/h); a Python scalar divided by a tensor is the tensor's reciprocal
// times the scalar; x ** 2 and x ** 3 are x*x and x*x*x. A sum
// over the five species adds them in the order of PyTorch's CUDA
// reduction (sum5). A lane whose state is not finite gives non-finite
// rows or blocks in its own lane only, where the plain version gives them.
#include <cuda_runtime.h>

namespace {

constexpr int NF = 7;
constexpr int kThreads = 64;   // lanes per block
// Grid points each thread walks. On the H100 at (51, 15,360) one segment
// of 51 leaves 15,360 threads, too few to hide the loads' latency: device
// ms rows / blocks 0.171 / 0.375 at 51, 0.058 / 0.230 at 13, 0.051 /
// 0.219 at 3, 0.051 / 0.202 at 1 (PERF.md).
constexpr int kSeg = 3;

// The model's constants (models/methanation.py) in float32, each beside
// the Python expression it stands for; the CPU test
// tests/test_torch_methanation.py::test_march_kernel_constants holds them
// to the module's values.
constexpr float kR = 8.3144589f;        // R_GAS
constexpr float kRcpR = 0.120272405f;   // 1.0 / R_GAS
constexpr float kDisp = 0.95e-5f;       // DZ_DISP
constexpr float kRhos = 5075.0f;        // RHOS
constexpr float kCps = 698.0f;          // CPS
constexpr float kMinusHR = 164940.0f;   // -HR
constexpr float kCpg = 2800.0f;         // CPG
constexpr float kKeff = 0.72f;          // KEFF
constexpr float kKeff2 = 1.44f;         // 2.0 * KEFF
constexpr float kWall = 27299.2f;       // 2.0 * U_HT / DINT
constexpr float kRate = 5075e3f;        // 5075e3
constexpr float kGuard = 0.001f;        // 0.001
constexpr float kMega = 1e-6f;          // 1e-6
constexpr float kMilli = 1e-3f;         // 1e-3
constexpr float kKappa = 0.1f;          // 0.1

// SC and MOLW: stoichiometry and molar masses (g/mol) of H2, CO2, CH4,
// H2O, Ar.
__host__ __device__ constexpr float sc(int k) {
  return k == 0 ? -4.0f : k == 1 ? -1.0f : k == 2 ? 1.0f : k == 3 ? 2.0f
                                                                  : 0.0f;
}
__host__ __device__ constexpr float molw(int k) {
  return k == 0 ? 2.0f : k == 1 ? 44.0f : k == 2 ? 16.0f : k == 3 ? 18.0f
                                                                  : 40.0f;
}

struct Lane {
  float Tj, uin, vd, dz, P0;   // condv: T_jacket, u_in, void, dz, P0
  float k[8];                  // Af, Eaf, Ar, Ear, BCO2, dHCO2, BH2O, dHH2O
};

// clamp_min(x, lo) as PyTorch has it: a NaN stays NaN.
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return x < lo ? lo : x;
}

// torch.sum over the species axis on CUDA: four accumulators, each
// starting at 0, the fifth value into the first, then combined in order.
__device__ __forceinline__ float sum5(const float (&x)[5]) {
  float v0 = 0.0f + x[0];
  const float v1 = 0.0f + x[1], v2 = 0.0f + x[2], v3 = 0.0f + x[3];
  v0 = v0 + x[4];
  return ((v0 + v1) + v2) + v3;
}

// S0 = sum(C), S1 = sum(C * MOLW).
__device__ __forceinline__ void sums(const float (&y)[NF], float& S0,
                                     float& S1) {
  float c[5], cm[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    c[k] = y[k];
    cm[k] = y[k] * molw(k);
  }
  S0 = sum5(c);
  S1 = sum5(cm);
}

// -F at one grid point: the inlet, outlet or PDE rows by the point's flags
// (a select, as torch.where: the rows not chosen are not computed).
__device__ __forceinline__ void rows_at(const float (&ym)[NF],
                                        const float (&y)[NF],
                                        const float (&yp)[NF],
                                        const float (&yd)[NF], float fi,
                                        float ff, float fo, const Lane& L,
                                        float (&F)[NF]) {
  const float T_m = ym[5], u_m = ym[6], T = y[5], u = y[6], T_p = yp[5];
  const float Td = yd[5];
  if (fi > 0.0f) {
#pragma unroll
    for (int k = 0; k < 5; ++k) F[k] = yd[k];
    F[5] = Td;
    F[6] = u - L.uin;
    return;
  }
  if (fo > 0.0f) {
#pragma unroll
    for (int k = 0; k < 5; ++k) F[k] = y[k] - ym[k];
    F[5] = u - u_m;
    F[6] = T - T_m;
    return;
  }
  const float dz = L.dz, vd = L.vd, P0 = L.P0, dz2 = dz * dz;
  const float solid = 1.0f - vd;
  const bool first = ff > 0.0f;
  // rate_rCH4
  const float RT = T * kR;
  const float PH2 = y[0] * kR * T * kMega, PCO2 = y[1] * kR * T * kMega;
  const float PCH4 = y[2] * kR * T * kMega, PH2O = y[3] * kR * T * kMega;
  const float kf = L.k[0] * expf(-L.k[1] / RT);
  const float ks = L.k[2] * expf(-L.k[3] / RT);
  const float kC = L.k[4] * expf(-L.k[5] / RT);
  const float kW = L.k[6] * expf(-L.k[7] / RT);
  const float a = 1.0f + kC * PCO2, b = 1.0f + kW * PH2O;
  const float rf = kRate * kf * kC * PCO2 * sqrtf(clamp_lo(PH2, kGuard)) /
                   (a * a);
  const float rr = kRate * ks * kW * PH2O * (PCH4 * PCH4) / (b * b);
  const float r = rf - rr;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float conv = (u * y[k] - u_m * ym[k]) / dz;
    const float lap = (first ? yp[k] - y[k] : yp[k] - 2.0f * y[k] + ym[k]) /
                      dz2;
    F[k] = -vd * yd[k] - conv + vd * kDisp * lap + solid * sc(k) * r;
  }
  const float iTm = 1.0f / T_m, iT = 1.0f / T, iTp = 1.0f / T_p;
  const float tmb = -u * P0 * (iT - iTm) / dz - P0 * iT * (u - u_m) / dz +
                    vd * kDisp * P0 * (iTp - 2.0f * iT + iTm) / dz2 +
                    solid * kR * (-2.0f) * r;
  F[5] = tmb + (first ? P0 * vd * (iT * iT) * Td : 0.0f);
  float S0, S1;
  sums(y, S0, S1);
  const float rho = P0 / RT * S1 / S0 * kMilli;
  const float heatcap = vd * rho * kCpg + solid * kRhos * kCps;
  const float kappa = first ? 1.0f : kKappa;
  F[6] = -kappa * heatcap * Td - rho * kCpg * (T * u - T_m * u_m) / dz +
         kKeff * (T_p - 2.0f * T + T_m) / dz2 + solid * kMinusHR * r -
         (T - L.Tj) * kWall;
}

// One grid point's blocks: A, B + D*coef, C, each written whole (zeros
// included) at row i, with the edge folds of ops/dae_fast.py::
// newton_blocks at i = 0 (B += A, A = 0) and i = nx - 1 (B += C, C = 0).
// zc = 0*coef is what D's zero entries add to B.
__device__ __forceinline__ void blocks_at(
    const float (&ym)[NF], const float (&y)[NF], const float (&yp)[NF],
    const float (&yd)[NF], float fi, float ff, float fo, float coef,
    const Lane& L, bool edge0, bool edge1, float* Ai, float* Bi, float* Ci,
    size_t snb) {
  const float T_m = ym[5], u_m = ym[6], T = y[5], u = y[6], T_p = yp[5];
  const float Td = yd[5];
  const float dz = L.dz, vd = L.vd, P0 = L.P0, dz2 = dz * dz;
  const float pde = (1.0f - fi) * (1.0f - fo);
  const float solid = 1.0f - vd;
  const float iT = 1.0f / T, iTm = 1.0f / T_m;
  const float rdz2 = 1.0f / dz2;     // KEFF / dz ** 2: a scalar over dz2
  const float zc = 0.0f * coef;

  // rate-law partials
  const float RT = T * kR;
  const float RT6 = RT * kMega;
  const float PH2 = y[0] * RT6, PCO2 = y[1] * RT6;
  const float PCH4 = y[2] * RT6, PH2O = y[3] * RT6;
  const float kf = L.k[0] * expf(-L.k[1] / RT);
  const float ks = L.k[2] * expf(-L.k[3] / RT);
  const float kC = L.k[4] * expf(-L.k[5] / RT);
  const float kW = L.k[6] * expf(-L.k[7] / RT);
  const float PH2g = clamp_lo(PH2, kGuard);
  const float s = sqrtf(PH2g);
  const float guard = PH2 >= kGuard ? 1.0f : 0.0f;   // ties go to PH2
  const float a = kC * PCO2, b = kW * PH2O;
  const float a1 = 1.0f + a, b1 = 1.0f + b;
  const float rf = kRate * kf * a * s / (a1 * a1);
  const float rr = kRate * ks * kW * PH2O * (PCH4 * PCH4) / (b1 * b1);
  const float invRT2 = 1.0f / (RT * T);
  float dr[4];
  dr[0] = rf * guard * ((1.0f / PH2g) * 0.5f) * RT6;
  dr[1] = kRate * kf * s * kC * (1.0f - a) / (a1 * a1 * a1) * RT6;
  dr[2] = -(kRate * ks * kW * PH2O * 2.0f * PCH4 / (b1 * b1)) * RT6;
  dr[3] = -(kRate * ks * (PCH4 * PCH4) * kW * (1.0f - b) / (b1 * b1 * b1)) *
          RT6;
  const float dlnrf = L.k[1] * invRT2 + guard * 0.5f * iT +
                      (L.k[5] * invRT2 + iT) * (1.0f - a) / a1;
  const float dlnrr = L.k[3] * invRT2 + 2.0f * iT +
                      (L.k[7] * invRT2 + iT) * (1.0f - b) / b1;
  const float drT = rf * dlnrf - rr * dlnrr;

  // density and heat-capacity partials (energy row); "/ R_GAS" is a
  // multiply by its reciprocal
  float S0, S1;
  sums(y, S0, S1);
  const float rho = P0 * iT * kRcpR * S1 / S0 * kMilli;
  const float heatcap = vd * rho * kCpg + solid * kRhos * kCps;
  const float kappa = ff > 0.0f ? 1.0f : kKappa;
  const float denb = -kappa * vd * kCpg * Td - kCpg * (T * u - T_m * u_m) / dz;
  const float drho_dT = -rho * iT;
  const float disp = vd * kDisp / dz2;

  // slot 3, D: only its diagonal, (5,5) and (6,5) are not zero
  const float Dk = fi - pde * vd;
  const float D55 = fi + pde * ff * P0 * vd * (iT * iT);
  const float D65 = pde * (-kappa * heatcap);

  // slot 0, A: (k,k), (k,6), (5,5), (5,6), (6,5), (6,6)
  float Akk = pde * (u_m / dz + disp * (1.0f - ff)) - fo;
  float Ak6[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) Ak6[k] = pde * (ym[k] / dz);
  const float A55 = pde * (-u * P0 * (iTm * iTm) / dz - disp * P0 * (iTm * iTm));
  const float A56 = pde * (P0 * iT / dz) - fo;
  const float A65 = pde * (rho * kCpg * u_m / dz + rdz2 * kKeff) - fo;
  const float A66 = pde * (rho * kCpg * T_m / dz);
  auto A_at = [&](int r, int c) -> float {
    if (r < 5) return c == r ? Akk : c == 6 ? Ak6[r] : 0.0f;
    if (r == 5) return c == 5 ? A55 : c == 6 ? A56 : 0.0f;
    return c == 5 ? A65 : c == 6 ? A66 : 0.0f;
  };

  // slot 2, C: (k,k), (5,5), (6,5)
  const float Ckk = pde * disp;
  const float C55 = -pde * disp * P0 / (T_p * T_p);
  const float C65 = pde * kKeff / dz2;
  auto C_at = [&](int r, int c) -> float {
    if (r < 5) return c == r ? Ckk : 0.0f;
    return c == 5 ? (r == 5 ? C55 : C65) : 0.0f;
  };

  auto put = [&](float* M, int r, int c, float v) {
    M[static_cast<size_t>(r * NF + c) * snb] = v;
  };
#pragma unroll
  for (int r = 0; r < NF; ++r)
#pragma unroll
    for (int c = 0; c < NF; ++c) {
      put(Ai, r, c, edge0 ? 0.0f : A_at(r, c));
      put(Ci, r, c, edge1 ? 0.0f : C_at(r, c));
    }

  // slot 1, B, row by row; then + D*coef and the folds, entry by entry
  float row[NF];
  auto finish = [&](int r, int dcol, float dval) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      float v = row[j] + (j == dcol ? dval * coef : zc);
      if (edge0) v = v + A_at(r, j);
      if (edge1) v = v + C_at(r, j);
      put(Bi, r, j, v);
    }
  };
  const float lap_diag = disp * (ff > 0.0f ? -1.0f : -2.0f);
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    float diag = -u / dz + lap_diag;
    if (k < 4) diag = diag + solid * sc(k) * dr[k];
#pragma unroll
    for (int j = 0; j < NF; ++j) row[j] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j != k) row[j] = pde * solid * sc(k) * dr[j];
    row[k] = pde * diag + fo;
    row[5] = pde * solid * sc(k) * drT;
    row[6] = pde * (-y[k] / dz);
    finish(k, k, Dk);
  }
  // row 5: total-mass balance (outlet: u - u_m)
#pragma unroll
  for (int j = 0; j < 4; ++j) row[j] = pde * solid * kR * (-2.0f) * dr[j];
  row[4] = 0.0f;
  row[5] = pde * (u * P0 * (iT * iT) / dz + P0 * (u - u_m) * (iT * iT) / dz +
                  2.0f * disp * P0 * (iT * iT) + solid * kR * (-2.0f) * drT -
                  ff * 2.0f * P0 * vd * (iT * iT * iT) * Td);
  row[6] = pde * (-P0 * (iT - iTm) / dz - P0 * iT / dz) + fo;
  finish(5, 5, D55);
  // row 6: energy balance (outlet: T - T_m; inlet: u - u_in)
  const float kappa0 = P0 * iT * kRcpR * kMilli / S0;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    float e = denb * kappa0 * (molw(j) - S1 / S0);
    if (j < 4) e = e + solid * kMinusHR * dr[j];
    row[j] = pde * e;
  }
  row[5] = pde * (denb * drho_dT - rho * kCpg * u / dz - rdz2 * kKeff2 +
                  solid * kMinusHR * drT - kWall) +
           fo;
  row[6] = pde * (-rho * kCpg * T / dz) + fi;
  finish(6, 5, D65);
}

struct Args {
  const float* y;      // (7, nx, nb)
  const float* c;      // (7, nx, nb), the BDF constant
  const float* flags;  // [f * sf + i * sx]: is_inlet, is_first, is_outlet
  const float* condv;  // (5, nb)
  const float* kin;    // (8, nb)
  const float* hl;     // (nb,) per-lane step, or null: the scalar h
  float* rhs;          // (nx, 7, nb)
  float *A, *B, *C;    // (nx, 7, 7, nb), march_blocks only
  int nx, nb, sf, sx;
  float alpha, rh, coef;   // rh = 1/h and coef = alpha/h, scalar h only
};

__device__ __forceinline__ void load_point(float (&v)[NF], const float* p,
                                           int i, int nx, size_t snb) {
#pragma unroll
  for (int f = 0; f < NF; ++f) v[f] = p[(static_cast<size_t>(f) * nx + i) * snb];
}

template <bool kBlocks>
__device__ __forceinline__ void walk(const Args& g) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= g.nb) return;
  const int i0 = blockIdx.y * kSeg;
  const int i1 = min(i0 + kSeg, g.nx);
  const size_t snb = static_cast<size_t>(g.nb);
  const float* y = g.y + lane;
  const float* c = g.c + lane;

  Lane L;
  L.Tj = g.condv[lane];
  L.uin = g.condv[snb + lane];
  L.vd = g.condv[2 * snb + lane];
  L.dz = g.condv[3 * snb + lane];
  L.P0 = g.condv[4 * snb + lane];
#pragma unroll
  for (int k = 0; k < 8; ++k) L.k[k] = g.kin[k * snb + lane];
  // yd = (alpha*y + c)/h: over a scalar h, a multiply by the host's 1/h;
  // D's factor alpha/h: the host's coef, or over a per-lane h, 1/h * alpha
  const float hl = g.hl ? g.hl[lane] : 0.0f;
  const float coef = g.hl ? (1.0f / hl) * g.alpha : g.coef;

  float ym[NF], yc[NF], yp[NF], cc[NF];
  load_point(ym, y, max(i0 - 1, 0), g.nx, snb);
  load_point(yc, y, i0, g.nx, snb);
  load_point(yp, y, min(i0 + 1, g.nx - 1), g.nx, snb);
  load_point(cc, c, i0, g.nx, snb);
#pragma unroll 1
  for (int i = i0; i < i1; ++i) {
    // The next point's loads go out before this point's arithmetic.
    float yn[NF], cn[NF];
    load_point(yn, y, min(i + 2, g.nx - 1), g.nx, snb);
    load_point(cn, c, min(i + 1, g.nx - 1), g.nx, snb);
    const float fi = g.flags[i * g.sx];
    const float ff = g.flags[g.sf + i * g.sx];
    const float fo = g.flags[2 * g.sf + i * g.sx];
    float yd[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const float num = yc[f] * g.alpha + cc[f];
      yd[f] = g.hl ? num / hl : num * g.rh;
    }
    float F[NF];
    rows_at(ym, yc, yp, yd, fi, ff, fo, L, F);
    float* out = g.rhs + static_cast<size_t>(i) * NF * snb + lane;
#pragma unroll
    for (int f = 0; f < NF; ++f) out[f * snb] = -F[f];
    if constexpr (kBlocks) {
      const size_t at = static_cast<size_t>(i) * NF * NF * snb + lane;
      blocks_at(ym, yc, yp, yd, fi, ff, fo, coef, L, i == 0, i == g.nx - 1,
                g.A + at, g.B + at, g.C + at, snb);
    }
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      ym[f] = yc[f];
      yc[f] = yp[f];
      yp[f] = yn[f];
      cc[f] = cn[f];
    }
  }
}

__global__ void __launch_bounds__(kThreads) march_rows_kernel(Args g) {
  walk<false>(g);
}

__global__ void __launch_bounds__(kThreads) march_blocks_kernel(Args g) {
  walk<true>(g);
}

int launch(bool blocks, const Args& g, cudaStream_t s) {
  if (g.nx < 1 || g.nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((g.nb + kThreads - 1) / kThreads, (g.nx + kSeg - 1) / kSeg);
  if (blocks)
    march_blocks_kernel<<<grid, kThreads, 0, s>>>(g);
  else
    march_rows_kernel<<<grid, kThreads, 0, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y, c (7, nx, nb) -> rhs (nx, 7, nb). flags[f * sf + i * sx] is flag f
// (inlet, first interior, outlet) of grid point i; condv (5, nb), kin
// (8, nb); hl (nb,) the per-lane step, or null for the scalar h, whose
// 1/h and alpha/h (each rounded to float32 from the host's double) are rh
// and coef. All float32, contiguous but flags, on the device of `stream`.
extern "C" int march_rows_launch(const float* y, const float* c,
                                 const float* flags, const float* condv,
                                 const float* kin, const float* hl,
                                 float* rhs, int nx, int nb, int sf, int sx,
                                 float alpha, float rh, float coef,
                                 void* stream) {
  Args g{y, c, flags, condv, kin, hl, rhs, nullptr, nullptr, nullptr,
         nx, nb, sf, sx, alpha, rh, coef};
  return launch(false, g, static_cast<cudaStream_t>(stream));
}

// The same inputs -> A, B, C (nx, 7, 7, nb) and rhs (nx, 7, nb).
extern "C" int march_blocks_launch(const float* y, const float* c,
                                   const float* flags, const float* condv,
                                   const float* kin, const float* hl,
                                   float* A, float* B, float* C, float* rhs,
                                   int nx, int nb, int sf, int sx,
                                   float alpha, float rh, float coef,
                                   void* stream) {
  Args g{y, c, flags, condv, kin, hl, rhs, A, B, C,
         nx, nb, sf, sx, alpha, rh, coef};
  return launch(true, g, static_cast<cudaStream_t>(stream));
}
