// The SSP-RK stage kernels of fused_rk_stage.cu (first order, from the
// state or from cell fields) and their physics variants
// (fused_rk_stage_viscous.cu, fused_rk_stage_gravity.cu), shared by the
// three translation units so that their instantiations compile in
// parallel.  fused_rk_stage.cu has the scheme, the layout and the design;
// the viscous pass is described below, at viscous_pass.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

#include "euler_hll.cuh"
#include "muscl_pencil.cuh"

namespace {

// KEPES on the kepes fields of each cell (cell_fields_tuple): rho, v[3], p,
// log rho, log p staged, derived from the RIN input rows once per cell
// (with LOGS, log rho and log p are rows 5 and 6 of the input, not
// computed); rho/p, ke and vent0 derived from them per face frame, by the
// same operations, so to the same bits.
template <bool LOGS>
struct Kepes {
  static constexpr bool FIELDS = false;
  static constexpr int RIN = LOGS ? 7 : 5;
  static constexpr int RS = 7, RD = 5;
  using Params = Consts;
  using Cell = Fields;

  __device__ static __forceinline__ void convert(const float* r, float s[RS],
                                                 const Consts& k) {
    const float rho = r[0], inv_rho = 1.0f / rho;
    const float v0 = r[1] * inv_rho, v1 = r[2] * inv_rho, v2 = r[3] * inv_rho;
    const float ke = 0.5f * (v0 * v0 + v1 * v1 + v2 * v2);
    const float p = k.km1 * (r[4] - rho * ke);
    s[0] = rho;
    s[1] = v0;
    s[2] = v1;
    s[3] = v2;
    s[4] = p;
    s[5] = LOGS ? r[5] : logf(rho);
    s[6] = LOGS ? r[6] : logf(p);
  }

  // the fields, in cell_fields_tuple's operation order; torch divides by a
  // Python scalar on CUDA as a product with the scalar's float reciprocal,
  // so vent0's "/ (gamma - 1)" is that product
  template <int A>
  __device__ static __forceinline__ Fields cell(const float s[RS], const Consts& k) {
    Fields f;
    f.rho = s[0];
    f.v[0] = s[1];
    f.v[1] = s[2];
    f.v[2] = s[3];
    f.p = s[4];
    f.lrho = s[5];
    f.lp = s[6];
    f.ke = 0.5f * (s[1] * s[1] + s[2] * s[2] + s[3] * s[3]);
    f.rhop = s[0] / s[4];
    const float ent = s[6] - k.gamma * s[5];
    f.vent0 = (k.gamma - ent) * (1.0f / k.km1) - f.rhop * f.ke;
    return f;
  }

  template <int A>
  __device__ static __forceinline__ float flux(const Fields& L, const Fields& R,
                                               float, const Consts& k, float f[5]) {
    return kepes_flux<A>(L, R, k, f);
  }

  // T of the viscous terms from the kepes fields: 1 / (rho/p)
  __device__ static __forceinline__ float temperature(float rho, float p) {
    return 1.0f / (rho / p);
  }
};

// hll or hllc on the hll fields of each cell (cell_fields_tuple "hll"):
// rho, v[3], p, h and c staged, sqrt(rho) taken per face frame (the same
// bits); ke is not needed, the fluxes do not read it.
template <int FLUX>
struct Hll {
  static constexpr bool FIELDS = false;
  static constexpr int RIN = 5;
  static constexpr int RS = 7, RD = 5;
  using Params = Consts;
  using Cell = HllFields;

  __device__ static __forceinline__ void convert(const float* r, float s[RS],
                                                 const Consts& k) {
    const float rho = r[0], inv_rho = 1.0f / rho;
    const float v0 = r[1] * inv_rho, v1 = r[2] * inv_rho, v2 = r[3] * inv_rho;
    const float ke = 0.5f * (v0 * v0 + v1 * v1 + v2 * v2);
    const float p = k.km1 * (r[4] - rho * ke);
    const float h = (r[4] + p) * inv_rho;
    s[0] = rho;
    s[1] = v0;
    s[2] = v1;
    s[3] = v2;
    s[4] = p;
    s[5] = h;
    s[6] = sqrtf(k.km1 * (h - ke));
  }

  // the fields in the +A face frame
  template <int A>
  __device__ static __forceinline__ HllFields cell(const float s[RS], const Consts&) {
    using Fr = Frame<A>;
    return {s[0], s[1 + Fr::n], s[1 + Fr::t1], s[1 + Fr::t2], s[4], s[5], s[6], sqrtf(s[0]), 0.0f};
  }

  template <int A>
  __device__ static __forceinline__ float flux(const HllFields& L, const HllFields& R,
                                               float, const Consts& k, float f[5]) {
    return hll_family_flux<FLUX, A>(L, R, k, f);
  }

  // T of the viscous terms from the hll fields: p / rho
  __device__ static __forceinline__ float temperature(float rho, float p) {
    return p / rho;
  }
};

// The field-input stage: the staged rows are the caller's field rows of
// flux FLUX (ops/euler.cell_fields_tuple), read, not derived; cell<A>
// picks them into the flux's fields, and the stage state is recovered
// from them (_recover_state_rows).
template <int FLUX>
struct FieldRows {
  static constexpr bool FIELDS = true;
  static constexpr int RIN = FLUX == KEPES ? 10 : 9;
  static constexpr int RS = RIN, RD = 5;
  using Params = Consts;
  using Cell = std::conditional_t<FLUX == KEPES, Fields, HllFields>;

  __device__ static __forceinline__ void convert(const float* r, float s[RS],
                                                 const Consts&) {
#pragma unroll
    for (int i = 0; i < RS; ++i) s[i] = r[i];
  }

  // kepes: the fields as they are (the flux rotates); hll/hllc: in the
  // +A face frame
  template <int A>
  __device__ static __forceinline__ Cell cell(const float s[RS], const Consts&) {
    if constexpr (FLUX == KEPES) {
      return {s[0], {s[1], s[2], s[3]}, s[4], s[5], s[6], s[7], s[8], s[9]};
    } else {
      using Fr = Frame<A>;
      return {s[0], s[1 + Fr::n], s[1 + Fr::t1], s[1 + Fr::t2], s[4], s[5], s[6], s[7], s[8]};
    }
  }

  template <int A>
  __device__ static __forceinline__ float flux(const Cell& L, const Cell& R,
                                               float, const Consts& k, float f[5]) {
    if constexpr (FLUX == KEPES)
      return kepes_flux<A>(L, R, k, f);
    else
      return hll_family_flux<FLUX, A>(L, R, k, f);
  }

  // the stage state of a cell from its field rows q(i): m = rho v, e =
  // p / (gamma - 1) + rho ke (kepes) or rho h - p (hll/hllc)
  template <class Row>
  __device__ static __forceinline__ void recover(const Row& q, const Consts& k,
                                                 float u[5]) {
    const float rho = q(0);
    u[0] = rho;
    u[1] = rho * q(1);
    u[2] = rho * q(2);
    u[3] = rho * q(3);
    u[4] = FLUX == KEPES ? q(4) * k.inv_km1 + rho * q(9) : rho * q(5) - q(4);
  }
};

// What a stage adds to the first-order divergence: nothing (the kernels
// of fused_rk_stage.cu), the gravity source (fused_rk_stage_gravity.cu),
// or the Navier-Stokes divergence with the gravity source as a runtime
// switch (fused_rk_stage_viscous.cu).
enum Phys { INVISCID = 0, GRAVITY = 1, VISCOUS = 2 };

// A block takes a slab of PL planes along axis 0 (2 at 3D extent 8, else
// the whole element) of as many elements as its threads leave, with
// registers for two blocks per SM.  State input: 256 threads, one per
// pencil (16 elements at 3D extent 8).  Field input: FIELDS_SLOTS / T
// elements (T pencils of a slab along the other axes), FIELDS_SPLIT
// threads per pencil (8 elements and 256 threads at 3D extent 8).  The
// viscous stage takes whole elements (PL = EXT: its stencil reaches the
// planes on both sides of a cell) of as many elements as VISC_SLOTS
// pencils leave (4 at 3D extent 8), VISC_SPLIT threads per pencil, one
// block per SM (shared memory): 512 threads at 3D extent 8.
constexpr int FIELDS_SLOTS = 128, FIELDS_SPLIT = 2;
constexpr int VISC_SLOTS = 256, VISC_SPLIT = 2;

__host__ __device__ constexpr int stage_planes(int dim, int ext, int ph = INVISCID) {
  return dim == 3 && ext == 8 && ph != VISCOUS ? 2 : ext;
}

template <class P, int DIM, int EXT, int PH = INVISCID>
struct StageShape {
  static constexpr int PL = stage_planes(DIM, EXT, PH);
  static constexpr int T = PL * t8pencil::ipow(EXT, DIM - 1) / EXT;  // pencils
  using Blk = std::conditional_t<
      P::FIELDS,
      t8pencil::Block<FIELDS_SLOTS / T, FIELDS_SPLIT, 2>,
      std::conditional_t<PH == VISCOUS,
                         t8pencil::Block<VISC_SLOTS / T, VISC_SPLIT, 1>,
                         t8pencil::Block<256 / T, 1, 2>>>;
};

// The staged tile holds each cell's fields, the divergence tile D.
template <class P, int DIM, int EXT, int PH = INVISCID>
using StageTile = t8pencil::Tile<P::RS, DIM, EXT, typename StageShape<P, DIM, EXT, PH>::Blk,
                                 StageShape<P, DIM, EXT, PH>::PL, P::RD>;

// The extras operand: the 2*DIM sides' additive layers, null where a side
// has none; an empty stand-in for the instantiations without extras.
struct Extras {
  const float* x[6];
};
struct NoExtras {};
template <bool EXTRAS>
using ExtrasArg = std::conditional_t<EXTRAS, Extras, NoExtras>;

// Per side k, the offset t * E + e of tile cell c (slab `slab`, element
// e) in x_k when x_k is given and c lies on side k's boundary layer, else
// -1: t is c's index over the axes other than k / 2, in increasing order.
template <int DIM, int EXT, int B>
__device__ __forceinline__ void extras_offsets(const Extras& xs, int slab, int c,
                                               long long Es, int e,
                                               long long off[2 * DIM]) {
  const int gc = slab * B + c;  // the cell's index in the element's block
  int i[DIM];
#pragma unroll
  for (int a = DIM - 1, rem = gc; a >= 0; --a, rem /= EXT) i[a] = rem % EXT;
#pragma unroll
  for (int k = 0; k < 2 * DIM; ++k) {
    const int a = k / 2;
    int t = 0;
#pragma unroll
    for (int b = 0; b < DIM; ++b)
      if (b != a) t = t * EXT + i[b];
    const bool on = xs.x[k] != nullptr && i[a] == (k % 2 == 0 ? EXT - 1 : 0);
    off[k] = on ? (long long)t * Es + e : -1;
  }
}

// The physics operand of the GRAVITY and VISCOUS stages: the viscous
// weights wv [8, E] (row 0 the cell size h, rows 1+k side k's
// equal-level weight, 0 at walls, hanging sides and dead slots), mu and
// kappa = mu gamma / ((gamma - 1) Pr) rounded to float as the plain
// version's scalars are, and the gravity switch and vector; an empty
// stand-in for the inviscid stage.
struct Physics {
  const float* wv;
  float mu, kappa;
  int gravity;
  float g[3];
};
struct NoPhysics {};
template <int PH>
using PhysicsArg = std::conditional_t<PH == INVISCID, NoPhysics, Physics>;

// The viscous pass's shared memory after the walk's: the D_visc tile
// (DIM + 1 rows: the momentum rows of the axes, then the energy) in the
// walk's tile layout, and per side k the facing layer's (v_x, v_y, v_z,
// T) rows [2 DIM][4][EXT^(DIM-1)][TE].
template <class Tl, int DIM, int EXT>
struct ViscTile {
  static constexpr int T0 = t8pencil::ipow(EXT, DIM - 1);
  static constexpr int VD = (DIM + 1) * Tl::BP * Tl::TE;
  static constexpr int FLOATS = VD + 2 * DIM * 4 * T0 * Tl::TE;
  static_assert(Tl::SMEM + (size_t)FLOATS * sizeof(float) <= 232448,
                "a block holds at most 227 KB");
};

// (v_x, v_y, v_z, T) of a state's rows r (rho, m, e), by
// cell_fields_tuple's operations (those of the policies' convert).
template <class P>
__device__ __forceinline__ void state_phi(const float r[5], const Consts& k,
                                          float out[4]) {
  const float rho = r[0], inv_rho = 1.0f / rho;
  const float v0 = r[1] * inv_rho, v1 = r[2] * inv_rho, v2 = r[3] * inv_rho;
  const float ke = 0.5f * (v0 * v0 + v1 * v1 + v2 * v2);
  const float p = k.km1 * (r[4] - rho * ke);
  out[0] = v0;
  out[1] = v1;
  out[2] = v2;
  out[3] = P::temperature(rho, p);
}

// Tangent axis ti (in increasing order) of the faces along axis a.
__host__ __device__ constexpr int tangent_axis(int a, int ti) {
  return ti < a ? ti : ti + 1;
}

// f(std::integral_constant<int, I>{}) for I = 0 .. N-1: a loop whose index
// is a constant expression.
template <int N, class F, int... I>
__device__ __forceinline__ void static_for(const F& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, class F>
__device__ __forceinline__ void static_for(const F& f) {
  static_for<N>(f, std::make_integer_sequence<int, N>{});
}

// Mask-aware derivative (d_hi m_hi + d_lo m_lo) / (m_hi + m_lo) / h of
// the plain version (_tile_viscous_divergence's cell_dt and lay_dt).
__device__ __forceinline__ float masked_dt(float d_hi, float m_hi, float d_lo,
                                           float m_lo, float inv_h) {
  return (d_hi * m_hi + d_lo * m_lo) / (m_hi + m_lo) * inv_h;
}

// A cell's data for the faces along axis A of the viscous walk: phi, and
// per tangent axis t its central of v_t (cd[t][0], the divergence) and of
// v_A (cd[t][1], the shear).
template <int NT>
struct VCell {
  float ph[4];
  float cd[NT][2];
};

// The viscous walk of one element slot x of a block (viscous_pass): the
// tiles, the element's 1/h, interior face area and side weights, every
// helper force-inlined so that the weights stay in registers.
template <class P, class Tl, int DIM, int EXT>
struct ViscWalk {
  static constexpr int TE = Tl::TE, T0 = t8pencil::ipow(EXT, DIM - 1), NT = DIM - 1;
  const float* st;  // staged rows: v in rows 1-3, T in row 5
  const float* sl;  // the side layers' phi [2 DIM][4][T0][TE]
  float* sd;        // D
  float* sv;        // D_visc
  int x;
  float inv_h, surface, mu, kappa;
  float eq[2 * DIM];

  // phi row j (v_x, v_y, v_z, T) of tile cell c, and of cell t of side s
  __device__ __forceinline__ float phi(int c, int j) const {
    return st[Tl::at(j < 3 ? 1 + j : 5, c, x)];
  }
  __device__ __forceinline__ float lay(int s, int t, int j) const {
    return sl[((s * 4 + j) * T0 + t) * TE + x];
  }
  template <int B>
  __device__ static __forceinline__ int digit(int c) {
    constexpr int s = t8pencil::ipow(EXT, DIM - 1 - B);
    return c / s % EXT;
  }
  // index of cell c in the side layers of axis U (the other axes in
  // increasing order, the last fastest)
  template <int U>
  __device__ static __forceinline__ int lidx(int c) {
    int l = 0;
    static_for<NT>([&](auto ti) {
      constexpr int TI = decltype(ti)::value;
      l = l * EXT + digit<tangent_axis(U, TI)>(c);
    });
    return l;
  }
  // cell_dt: row j of cell c along axis u, the outward neighbours from
  // the facing layers, eq-masked
  template <int U, int J>
  __device__ __forceinline__ float cell_dt(int c) const {
    const int iu = digit<U>(c);
    constexpr int su = t8pencil::ipow(EXT, DIM - 1 - U);
    const float me = phi(c, J);
    const bool hi_end = iu == EXT - 1, lo_end = iu == 0;
    const float hv = hi_end ? lay(2 * U, lidx<U>(c), J) : phi(c + su, J);
    const float lv = lo_end ? lay(2 * U + 1, lidx<U>(c), J) : phi(c - su, J);
    return masked_dt(hv - me, hi_end ? eq[2 * U] : 1.0f, me - lv,
                     lo_end ? eq[2 * U + 1] : 1.0f, inv_h);
  }
  // lay_dt: one-sided at the layer's borders, from the values vm, v0, vp
  // at li - 1, li, li + 1 (those beyond a border are not used)
  __device__ __forceinline__ float lay_dt(int li, float vm, float v0, float vp) const {
    const bool up = li < EXT - 1, dn = li > 0;
    const float d_hi = up ? vp - v0 : 0.0f;
    const float d_lo = dn ? v0 - vm : 0.0f;
    return masked_dt(d_hi, up ? 1.0f : 0.0f, d_lo, dn ? 1.0f : 0.0f, inv_h);
  }

  template <int A>
  __device__ __forceinline__ void vcell(int c, VCell<NT>& v) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) v.ph[j] = phi(c, j);
    static_for<NT>([&](auto ti) {
      constexpr int TI = decltype(ti)::value;
      constexpr int TT = tangent_axis(A, TI);
      v.cd[TI][0] = cell_dt<TT, TT>(c);
      v.cd[TI][1] = cell_dt<TT, A>(c);
    });
  }

  // the flux rows (tau_0 .. tau_{DIM-1}, work + heat) of one face along A
  // times its weight, from the normal derivatives, the face velocity and
  // the face's tangent derivatives of v_t (ft) and v_A (fa)
  template <int A>
  __device__ __forceinline__ void face(const float (&dn)[4], const float (&vf)[DIM],
                                       const float (&ft)[NT > 0 ? NT : 1],
                                       const float (&fa)[NT > 0 ? NT : 1],
                                       float wgt, float (&f)[DIM + 1]) const {
    constexpr float C23 = (float)(2.0 / 3.0);
    float sdt = 0.0f;
#pragma unroll
    for (int ti = 0; ti < NT; ++ti) sdt = sdt + ft[ti];
    const float div = dn[A] + sdt;
    float tau[DIM];
    tau[A] = mu * (2.0f * dn[A] - C23 * div);
    static_for<NT>([&](auto ti) {
      constexpr int TI = decltype(ti)::value;
      constexpr int TT = tangent_axis(A, TI);
      tau[TT] = mu * (dn[TT] + fa[TI]);
    });
    float work = 0.0f;
#pragma unroll
    for (int j = 0; j < DIM; ++j) work = work + vf[j] * tau[j];
    const float heat = kappa * dn[3];
#pragma unroll
    for (int j = 0; j < DIM; ++j) f[j] = tau[j] * wgt;
    f[DIM] = (work + heat) * wgt;
  }

  // a mesh face's tangent derivatives: the mean of my boundary plane's
  // (cell c) and the facing layer's (side s, cell t) within-layer ones,
  // of v_t into ft and of v_A into fa
  template <int A>
  __device__ __forceinline__ void mesh_dt(int c, int s, int t,
                                          float (&ft)[NT > 0 ? NT : 1],
                                          float (&fa)[NT > 0 ? NT : 1]) const {
    static_for<NT>([&](auto ti) {
      constexpr int TI = decltype(ti)::value;
      constexpr int TT = tangent_axis(A, TI);
      constexpr int cs = t8pencil::ipow(EXT, DIM - 1 - TT);  // cell stride
      constexpr int ls = t8pencil::ipow(EXT, NT - 1 - TI);   // layer stride
      const int li = digit<TT>(c);
      const int om = li > 0 ? 1 : 0, op = li < EXT - 1 ? 1 : 0;  // in range
      ft[TI] = 0.5f * (lay_dt(li, phi(c - om * cs, TT), phi(c, TT), phi(c + op * cs, TT)) +
                       lay_dt(li, lay(s, t - om * ls, TT), lay(s, t, TT),
                              lay(s, t + op * ls, TT)));
      fa[TI] = 0.5f * (lay_dt(li, phi(c - om * cs, A), phi(c, A), phi(c + op * cs, A)) +
                       lay_dt(li, lay(s, t - om * ls, A), lay(s, t, A),
                              lay(s, t + op * ls, A)));
    });
  }

  // walk segment seg of pencil t along A, its cells [seg Ls, (seg + 1)
  // Ls), Ls = EXT / SPLIT: each face of theirs once (the face between two
  // segments in both, the same bits), D_visc of each cell once (into sv,
  // or D_adv + D_visc into sd on the last axis)
  template <int A>
  __device__ __forceinline__ void pencil(int t, int seg) const {
    constexpr bool FIRST = A == 0, LAST = A == DIM - 1;
    constexpr int stride = t8pencil::ipow(EXT, DIM - 1 - A);
    constexpr int Ls = EXT / Tl::SPLIT;
    const int c0 = t8pencil::pencil_start<DIM, EXT, A>(t);
    const float w_hi = eq[2 * A] * surface, w_lo = eq[2 * A + 1] * surface;
    const int q0 = seg * Ls;
    VCell<NT> L, R;     // cells q - 1 and q
    if (q0 > 0) vcell<A>(c0 + (q0 - 1) * stride, L);
    float fl[DIM + 1];  // the weighted flux of cell q-1's lo face
#pragma unroll 1
    for (int q = q0; q <= q0 + Ls; ++q) {
      if (q < EXT) vcell<A>(c0 + q * stride, R);
      float dn[4], vf[DIM], ft[NT > 0 ? NT : 1], fa[NT > 0 ? NT : 1], fw[DIM + 1], wgt;
      if (q == 0 || q == EXT) {
        // a mesh face: side 2A+1 | cell 0, or cell EXT-1 | side 2A
        const bool lo = q == 0;
        const int s = lo ? 2 * A + 1 : 2 * A;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float o = lay(s, t, j), mine = lo ? R.ph[j] : L.ph[j];
          const float left = lo ? o : mine, right = lo ? mine : o;
          dn[j] = (right - left) * inv_h;
          if (j < DIM) vf[j] = 0.5f * (left + right);
        }
        mesh_dt<A>(lo ? c0 : c0 + (EXT - 1) * stride, s, t, ft, fa);
        wgt = lo ? w_lo : w_hi;
      } else {  // interior: cell q-1 | cell q
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dn[j] = (R.ph[j] - L.ph[j]) * inv_h;
          if (j < DIM) vf[j] = 0.5f * (L.ph[j] + R.ph[j]);
        }
#pragma unroll
        for (int ti = 0; ti < NT; ++ti) {
          ft[ti] = 0.5f * (L.cd[ti][0] + R.cd[ti][0]);
          fa[ti] = 0.5f * (L.cd[ti][1] + R.cd[ti][1]);
        }
        wgt = surface;
      }
      face<A>(dn, vf, ft, fa, wgt, fw);
      if (q > q0) {  // both faces of cell q-1 known
        const int c = c0 + (q - 1) * stride;
        float dv[DIM + 1];
#pragma unroll
        for (int r = 0; r <= DIM; ++r)
          dv[r] = ((FIRST ? 0.0f : sv[Tl::at(r, c, x)]) + fw[r]) - fl[r];
        if constexpr (LAST) {
          // D = D_adv + D_visc, the mass row (and m_z in 2D) + 0
          sd[Tl::at(0, c, x)] = sd[Tl::at(0, c, x)] + 0.0f;
#pragma unroll
          for (int r = 0; r < DIM; ++r) sd[Tl::at(1 + r, c, x)] = sd[Tl::at(1 + r, c, x)] + dv[r];
          if constexpr (DIM == 2) sd[Tl::at(3, c, x)] = sd[Tl::at(3, c, x)] + 0.0f;
          sd[Tl::at(4, c, x)] = sd[Tl::at(4, c, x)] + dv[DIM];
        } else {
#pragma unroll
          for (int r = 0; r <= DIM; ++r) sv[Tl::at(r, c, x)] = dv[r];
        }
      }
#pragma unroll
      for (int r = 0; r <= DIM; ++r) fl[r] = fw[r];
      L = R;
    }
  }
};

// The Navier-Stokes divergence of the block's whole elements (PL = EXT),
// added to the advective D in sd: the tile math of _tile_viscous_divergence
// (t8gpu_tpu/ops/pallas_kernels.py:914-1086) in its operation order.
//
// Per cell, phi = (v, T) with v the staged rows 1-3 and T (computed into
// staged row 5, which the walk no longer reads) from rho and p: 1/(rho/p)
// (kepes) or p/rho; the side layers' phi from their states.  Per axis A,
// two threads walk each pencil along A, one segment each, and evaluate
// each interface once (the one between the segments twice, the same
// bits; ViscWalk::pencil):
//
//   dn    = (phi_R - phi_L) / h                       normal derivatives
//   dt_t  = mean of the two cells' mask-aware centrals along t (interior),
//           or of the two facing layers' within-layer derivatives (mesh)
//   tau_A = mu (2 dn_A - 2/3 (dn_A + sum_t dt_t v_t)),  tau_t = mu (dn_t + dt_t v_A)
//   F     = (0, tau, v_f . tau + kappa dn_T) w,   w = surface inside,
//           eq surface at the mesh faces
//   Dv(c) = (Dv(c) + F(c|c+1)) - F(c-1|c),         axis 0 first, from 0
//
// then D = D_adv + Dv on the last axis.  sv: the D_visc tile and the side
// layers' phi (ViscTile).  Every thread of the block calls it; it ends
// with a __syncthreads.
template <class P, class Tl, int DIM, int EXT>
__device__ __forceinline__ void viscous_pass(const t8pencil::Args& g,
                                             const Physics& ph, float* st,
                                             float* sd, float* sv, int e0,
                                             const Consts& k) {
  using VT = ViscTile<Tl, DIM, EXT>;
  constexpr int B = Tl::B, TE = Tl::TE, T0 = VT::T0;
  static_assert(B == t8pencil::ipow(EXT, DIM), "the viscous pass takes whole elements");
  float* sl = sv + VT::VD;  // the side layers' phi
  const long long Es = g.E;

  // T of every cell over staged row 5; the side layers' phi
  t8pencil::for_cells<Tl, B>(e0, g.E, [&](int c, int, int cx) {
    st[Tl::at(5, c, cx)] = P::temperature(st[Tl::at(0, c, cx)], st[Tl::at(4, c, cx)]);
  });
  static_for<2 * DIM>([&](auto side_) {   // a constant side: g.sides in registers
    constexpr int SIDE = decltype(side_)::value;
    t8pencil::for_cells<Tl, T0>(e0, g.E, [&](int t, int ee, int cx) {
      const float* base = g.sides[SIDE] + (long long)t * Es + ee;
      float r[5], out[4];
#pragma unroll
      for (int i = 0; i < 5; ++i) r[i] = __ldg(base + i * T0 * Es);
      state_phi<P>(r, k, out);
#pragma unroll
      for (int i = 0; i < 4; ++i) sl[((SIDE * 4 + i) * T0 + t) * TE + cx] = out[i];
    });
  });
  __syncthreads();

  const int x = threadIdx.x, y = threadIdx.y;
  const int e = e0 + x;
  const bool live = e < g.E;
  ViscWalk<P, Tl, DIM, EXT> vw{st, sl, sd, sv, x, 0.0f, 0.0f, ph.mu, ph.kappa, {}};
  if (live) {
    vw.inv_h = 1.0f / __ldg(ph.wv + e);
    vw.surface = __ldg(g.w + e);
#pragma unroll
    for (int s = 0; s < 2 * DIM; ++s) vw.eq[s] = __ldg(ph.wv + (1 + s) * Es + e);
  }
  // per axis the walk (the barriers: D_visc changes hands between the
  // threads)
  auto axis = [&](auto a_) {
    constexpr int A = decltype(a_)::value;
    if (live) {
#pragma unroll 1
      for (int i = y; i < T0 * Tl::SPLIT; i += Tl::SLOTS)
        vw.template pencil<A>(i % T0, i / T0);
    }
    __syncthreads();
  };
  axis(std::integral_constant<int, 0>{});
  axis(std::integral_constant<int, 1>{});
  if constexpr (DIM == 3) axis(std::integral_constant<int, 2>{});
}

// One stage for a block: it walks its slab of its elements' cells
// (walk1_slab; from the state, the fields derived as they are staged),
// (VISCOUS: the Navier-Stokes divergence added to D, viscous_pass), then
// the stage update (a u_prev + b u) + c w[7] (D + extras + S) in one
// pass, u the state rows of g.u or recovered from the staged field rows,
// S the gravity source (PH != INVISCID, when ph.gravity), and the
// per-element speed max.  up == nullptr (SHARE_PREV) means u_prev is u.
template <class P, int DIM, int EXT, bool SHARE_PREV, bool EXTRAS, int PH = INVISCID>
__device__ __forceinline__ void stage(const t8pencil::Args& g,
                                      const float* __restrict__ up,
                                      const Consts& k, float ca, float cb,
                                      float cc, const ExtrasArg<EXTRAS>& xs,
                                      const PhysicsArg<PH>& ph = {}) {
  using Tl = StageTile<P, DIM, EXT, PH>;
  constexpr int NSLAB = EXT / StageShape<P, DIM, EXT, PH>::PL;
  extern __shared__ float smem[];
  float* st = smem;             // fields
  float* sd = st + Tl::TILE;    // D
  float* red = sd + Tl::DTILE;  // [SLOTS][TE] speeds

  const int slab = blockIdx.x % NSLAB;
  const int e0 = (blockIdx.x / NSLAB) * Tl::TE;
  const float spd = t8pencil::walk1_slab<P, Tl, DIM, EXT>(g, st, sd, slab, e0, k);
  if constexpr (PH == VISCOUS)
    viscous_pass<P, Tl, DIM, EXT>(g, ph, st, sd, red + Tl::SLOTS * Tl::TE, e0, k);

  // the stage update, in _stage_update's operation order
  constexpr int B = Tl::B;
  const long long Es = g.E;
  const long long rs = (long long)t8pencil::ipow(EXT, DIM) * Es;  // row stride
  if constexpr (PH == INVISCID) {
  t8pencil::for_cells<Tl, B>(e0, g.E, [&](int c, int ee, int cx) {
    const long long off = (long long)(slab * B + c) * Es + ee;
    const float cdt = cc * __ldg(g.w + 7 * Es + ee);
    float uf[5];
    if constexpr (P::FIELDS)
      P::recover([&](int i) { return st[Tl::at(i, c, cx)]; }, k, uf);
    [[maybe_unused]] long long xo[2 * DIM];
    if constexpr (EXTRAS) extras_offsets<DIM, EXT, B>(xs, slab, c, Es, ee, xo);
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const float ur = P::FIELDS ? uf[r] : __ldg(g.u + r * rs + off);
      const float upr = SHARE_PREV ? ur : __ldg(up + r * rs + off);
      float d = sd[Tl::at(r, c, cx)];
      if constexpr (EXTRAS) {
        // the sides in increasing k, the plain version's order
        constexpr long long T = t8pencil::ipow(EXT, DIM - 1);
#pragma unroll
        for (int s = 0; s < 2 * DIM; ++s)
          if (xo[s] >= 0) d = d + __ldg(xs.x[s] + r * T * Es + xo[s]);
      }
      g.D[r * rs + off] = (ca * upr + cb * ur) + cdt * d;
    }
  });
  } else {
    // the state input's update with the gravity source S v_cell after
    // the extras (_fused_rk_kernel :1160-1178): S = (0, rho g, m . g),
    // the rows of a zero component zero, v_cell from w[0] = s: s s (2D)
    // or s sqrt(s) (3D), 0 on guard slots
    static_assert(!P::FIELDS, "the physics stages read the state");
    const bool share = SHARE_PREV || up == nullptr;
    t8pencil::for_cells<Tl, B>(e0, g.E, [&](int c, int ee, int cx) {
      const long long off = (long long)(slab * B + c) * Es + ee;
      const float cdt = cc * __ldg(g.w + 7 * Es + ee);
      float u[5];
#pragma unroll
      for (int r = 0; r < 5; ++r) u[r] = __ldg(g.u + r * rs + off);
      float src[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float vc = 0.0f;
      if (ph.gravity) {
        const float s = __ldg(g.w + ee);
        vc = DIM == 2 ? s * s : s * sqrtf(s);
#pragma unroll
        for (int i = 0; i < 3; ++i) src[1 + i] = ph.g[i] != 0.0f ? u[0] * ph.g[i] : 0.0f;
        src[4] = (u[1] * ph.g[0] + u[2] * ph.g[1]) + u[3] * ph.g[2];
      }
      [[maybe_unused]] long long xo[2 * DIM];
      if constexpr (EXTRAS) extras_offsets<DIM, EXT, B>(xs, slab, c, Es, ee, xo);
#pragma unroll
      for (int r = 0; r < 5; ++r) {
        const float upr = share ? u[r] : __ldg(up + r * rs + off);
        float d = sd[Tl::at(r, c, cx)];
        if constexpr (EXTRAS) {
          constexpr long long T = t8pencil::ipow(EXT, DIM - 1);
#pragma unroll
          for (int s = 0; s < 2 * DIM; ++s)
            if (xo[s] >= 0) d = d + __ldg(xs.x[s] + r * T * Es + xo[s]);
        }
        if (ph.gravity) d = d + src[r] * vc;
        g.D[r * rs + off] = (ca * upr + cb * u[r]) + cdt * d;
      }
    });
  }
  const int e = e0 + threadIdx.x;
  t8pencil::element_speed<Tl, (NSLAB > 1)>(red, spd, e < g.E, g.speed, e);
}

// The stage on 5-row states or 7-row states with their log rows.
template <class P, int DIM, int EXT, bool SHARE_PREV, bool EXTRAS>
__global__ void __launch_bounds__(StageTile<P, DIM, EXT>::THREADS,
                                  StageShape<P, DIM, EXT>::Blk::MIN_BLOCKS)
    fused_rk_stage_kernel(t8pencil::Args g, const float* __restrict__ up,
                          Consts k, float ca, float cb, float cc,
                          ExtrasArg<EXTRAS> xs) {
  stage<P, DIM, EXT, SHARE_PREV, EXTRAS>(g, up, k, ca, cb, cc, xs);
}

// The stage on cell-field rows (g.u is q).
template <class P, int DIM, int EXT, bool SHARE_PREV, bool EXTRAS>
__global__ void __launch_bounds__(StageTile<P, DIM, EXT>::THREADS,
                                  StageShape<P, DIM, EXT>::Blk::MIN_BLOCKS)
    fused_rk_stage_fields_kernel(t8pencil::Args g, const float* __restrict__ up,
                                 Consts k, float ca, float cb, float cc,
                                 ExtrasArg<EXTRAS> xs) {
  stage<P, DIM, EXT, SHARE_PREV, EXTRAS>(g, up, k, ca, cb, cc, xs);
}

// The stage on 5-row or 7-row states with the gravity source (GRAVITY)
// or the Navier-Stokes divergence and the gravity switch (VISCOUS).
template <class P, int DIM, int EXT, bool SHARE_PREV, bool EXTRAS, int PH>
__global__ void __launch_bounds__(StageTile<P, DIM, EXT, PH>::THREADS,
                                  StageShape<P, DIM, EXT, PH>::Blk::MIN_BLOCKS)
    fused_rk_stage_physics_kernel(t8pencil::Args g, const float* __restrict__ up,
                                  Consts k, float ca, float cb, float cc,
                                  ExtrasArg<EXTRAS> xs, Physics ph) {
  stage<P, DIM, EXT, SHARE_PREV, EXTRAS, PH>(g, up, k, ca, cb, cc, xs, ph);
}

// The case's kernel: state or field input, with what PH adds.
template <class P, int DIM, int EXT, bool SHARE_PREV, bool EXTRAS, int PH = INVISCID>
auto stage_kernel() {
  if constexpr (PH != INVISCID)
    return fused_rk_stage_physics_kernel<P, DIM, EXT, SHARE_PREV, EXTRAS, PH>;
  else if constexpr (P::FIELDS)
    return fused_rk_stage_fields_kernel<P, DIM, EXT, SHARE_PREV, EXTRAS>;
  else
    return fused_rk_stage_kernel<P, DIM, EXT, SHARE_PREV, EXTRAS>;
}

// Dynamic shared memory of a block: the tiles of the walk and, for the
// viscous stage, the D_visc tile (DIM + 1 rows) and the 2 DIM side
// layers' (v, T) rows.
template <class P, int DIM, int EXT, int PH>
constexpr size_t stage_smem() {
  using Tl = StageTile<P, DIM, EXT, PH>;
  if constexpr (PH == VISCOUS)
    return Tl::SMEM + ((size_t)ViscTile<Tl, DIM, EXT>::FLOATS) * sizeof(float);
  else
    return Tl::SMEM;
}

// What the stage reads: the 5-row state, the 7-row state with its log
// rows (kepes only), or the flux's cell-field rows.
enum Input { STATE = 0, LOGS = 1, FIELD_ROWS = 2 };

// Call fn.template run<P, DIM, EXT, SHARE_PREV, EXTRAS>() for the
// instantiation of the case; cudaErrorInvalidValue for a case none takes.
template <class Fn>
int with_case(int dim, int ext, int flux, int input, bool share_prev,
              bool extras, const Fn& fn) {
  auto by_shape = [&](auto physics) -> int {
    using P = decltype(physics);
    auto by_prev = [&](auto d, auto x) -> int {
      constexpr int D = decltype(d)::value, X = decltype(x)::value;
      if (extras)
        return share_prev ? fn.template run<P, D, X, true, true>()
                          : fn.template run<P, D, X, false, true>();
      return share_prev ? fn.template run<P, D, X, true, false>()
                        : fn.template run<P, D, X, false, false>();
    };
    using I3 = std::integral_constant<int, 3>;
    using I2 = std::integral_constant<int, 2>;
    using I8 = std::integral_constant<int, 8>;
    using I4 = std::integral_constant<int, 4>;
    if (dim == 3 && ext == 8) return by_prev(I3{}, I8{});
    if (dim == 3 && ext == 4) return by_prev(I3{}, I4{});
    if (dim == 2 && ext == 8) return by_prev(I2{}, I8{});
    if (dim == 2 && ext == 4) return by_prev(I2{}, I4{});
    return (int)cudaErrorInvalidValue;
  };
  if (input == FIELD_ROWS) {
    if (flux == KEPES) return by_shape(FieldRows<KEPES>{});
    if (flux == HLL) return by_shape(FieldRows<HLL>{});
    if (flux == HLLC) return by_shape(FieldRows<HLLC>{});
    return (int)cudaErrorInvalidValue;
  }
  if (flux == KEPES) return input == LOGS ? by_shape(Kepes<true>{}) : by_shape(Kepes<false>{});
  if (input == LOGS) return (int)cudaErrorInvalidValue;  // the log rows: kepes only
  if (flux == HLL) return by_shape(Hll<HLL>{});
  if (flux == HLLC) return by_shape(Hll<HLLC>{});
  return (int)cudaErrorInvalidValue;
}

// The physics stages take the state inputs only (no instantiation for
// the field rows), and decide at run time whether u_prev is u (up null)
// and which sides add extras (null pointers): their one instantiation per
// physics and shape is SHARE_PREV = false, EXTRAS = true, so that their
// sources build in a quarter of the time.
template <int PH, class P>
constexpr bool has_case() {
  return PH == INVISCID || !P::FIELDS;
}
template <int PH, bool SHARE_PREV, bool EXTRAS>
constexpr bool redirect() {
  return PH != INVISCID && (SHARE_PREV || !EXTRAS);
}

template <int PH>
struct Launcher {
  int device;
  const t8pencil::Args& g;
  const float* up;
  const Consts& k;
  float ca, cb, cc;
  const Extras& xs;
  const Physics& ph;
  cudaStream_t stream;
  template <class P, int DIM, int EXT, bool SHARE_PREV, bool EXTRAS>
  int run() const {
    if constexpr (!has_case<PH, P>()) {
      return (int)cudaErrorInvalidValue;
    } else if constexpr (redirect<PH, SHARE_PREV, EXTRAS>()) {
      return run<P, DIM, EXT, false, true>();
    } else {
      using Tl = StageTile<P, DIM, EXT, PH>;
      constexpr size_t SMEM = stage_smem<P, DIM, EXT, PH>();
      auto kern = stage_kernel<P, DIM, EXT, SHARE_PREV, EXTRAS, PH>();
      static bool raised[64] = {};
      const int err = t8pencil::raise_smem((const void*)kern, SMEM, device, raised);
      if (err != 0) return err;
      const dim3 block(Tl::TE, Tl::SLOTS);
      const dim3 grid((g.E + Tl::TE - 1) / Tl::TE * (EXT / stage_planes(DIM, EXT, PH)));
      if constexpr (PH != INVISCID) {
        kern<<<grid, block, SMEM, stream>>>(g, up, k, ca, cb, cc, xs, ph);
      } else if constexpr (EXTRAS) {
        kern<<<grid, block, SMEM, stream>>>(g, up, k, ca, cb, cc, xs);
      } else {
        kern<<<grid, block, SMEM, stream>>>(g, up, k, ca, cb, cc, NoExtras{});
      }
      return (int)cudaGetLastError();
    }
  }
};

template <int PH>
struct Attributes {
  int* out;
  template <class P, int DIM, int EXT, bool SHARE_PREV, bool EXTRAS>
  int run() const {
    if constexpr (!has_case<PH, P>()) {
      return (int)cudaErrorInvalidValue;
    } else if constexpr (redirect<PH, SHARE_PREV, EXTRAS>()) {
      return run<P, DIM, EXT, false, true>();
    } else {
      using Tl = StageTile<P, DIM, EXT, PH>;
      return t8pencil::kernel_attributes(
          (const void*)stage_kernel<P, DIM, EXT, SHARE_PREV, EXTRAS, PH>(),
          Tl::THREADS, stage_smem<P, DIM, EXT, PH>(), out);
    }
  }
};

template <int PH>
int launch(int device, int dim, int ext, int E, int flux, int input,
           const float* u, const float* up, const float* w,
           const float* const o[6], const float* const x[6], float* out,
           unsigned int* speed, double gamma, float ca, float cb, float cc,
           const Physics& ph, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E <= 0) return (int)cudaErrorInvalidValue;
  const t8pencil::Args g{u, w, {o[0], o[1], o[2], o[3], o[4], o[5]}, out, speed, E};
  const Consts k = make_consts(gamma);
  const Extras xs{{x[0], x[1], x[2], x[3], x[4], x[5]}};
  bool any = false;
  for (int s = 0; s < 6; ++s) {
    if (x[s] == nullptr) continue;
    if (s >= 2 * dim) return (int)cudaErrorInvalidValue;  // no such side
    any = true;
  }
  if (PH == VISCOUS && ph.wv == nullptr) return (int)cudaErrorInvalidValue;
  return with_case(dim, ext, flux, input, up == nullptr, any,
                   Launcher<PH>{device, g, up, k, ca, cb, cc, xs, ph,
                                static_cast<cudaStream_t>(stream)});
}

template <int PH>
int attributes(int device, int dim, int ext, int flux, int input,
               int share_prev, int extras, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return with_case(dim, ext, flux, input, share_prev != 0, extras != 0,
                   Attributes<PH>{out});
}

}  // namespace
