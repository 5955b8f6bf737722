// The SSP-RK stage kernels of fused_rk_stage.cu (first order, from the
// state or from cell fields) and their physics variants
// (fused_rk_stage_viscous.cu, fused_rk_stage_gravity.cu), shared by the
// three translation units so that their instantiations compile in
// parallel.  fused_rk_stage.cu has the scheme, the layout and the design;
// the viscous walk is described below, at viscous_walk.

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
// pencils leave (4 at 3D extent 8), VISC_SPLIT threads per pencil,
// VISC_MIN_BLOCKS blocks per SM (shared memory): 512 threads at 3D
// extent 8.
constexpr int FIELDS_SLOTS = 128, FIELDS_SPLIT = 2;
constexpr int VISC_SLOTS = 256, VISC_SPLIT = 2, VISC_MIN_BLOCKS = 1;

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
                         t8pencil::Block<VISC_SLOTS / T, VISC_SPLIT, VISC_MIN_BLOCKS>,
                         t8pencil::Block<256 / T, 1, 2>>>;
};

// The staged tile holds each cell's fields, the divergence tile D (the
// viscous stage stages its cells in its own layout, ViscTile).
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

// The viscous stage's shared memory: the staged cells, each of their
// LR = P::RS + 1 rows (the fields, then T) holding the tile's BP cell
// slots (Tl's padded layout) followed by the 2 DIM side layers' cells
// (slot BP + k T0 + t for cell t of side k), [LR][NSLOT][TE]; then the
// walk's D tile (D_adv, D on the last axis) and speeds, then the D_visc
// tile (DIM + 1 rows: the momentum rows of the axes, then the energy) in
// the D tile's layout.  A tile cell and a side-layer cell lie the same
// row stride apart, so a neighbour's row is one offset from its slot.
template <class Tl, int RS, int DIM, int EXT>
struct ViscTile {
  static constexpr int T0 = t8pencil::ipow(EXT, DIM - 1);
  static constexpr int LR = RS + 1, NSLOT = Tl::BP + 2 * DIM * T0;
  static constexpr int STAGED = LR * NSLOT * Tl::TE;
  static constexpr int VD = (DIM + 1) * Tl::BP * Tl::TE;
  static constexpr int FLOATS = STAGED + Tl::DTILE + Tl::SLOTS * Tl::TE + VD;
  static_assert((size_t)FLOATS * sizeof(float) <= 232448, "a block holds at most 227 KB");
};

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
// EXACT: the masks' sum is 2 or 1 and sc its reciprocal, a product as
// exact as the division, so the same bits.
template <bool EXACT>
__device__ __forceinline__ float masked_dt(float d_hi, float m_hi, float d_lo,
                                           float m_lo, float sc, float inv_h) {
  const float num = d_hi * m_hi + d_lo * m_lo;
  return (EXACT ? num * sc : num / (m_hi + m_lo)) * inv_h;
}

// g.sides[s] for a side s known at run time, by selects over constant
// indices (an indexed kernel parameter would go to local memory).
template <int DIM>
__device__ __forceinline__ const float* side_layer(const t8pencil::Args& g, int s) {
  const float* p = g.sides[0];
#pragma unroll
  for (int i = 1; i < 2 * DIM; ++i) p = s == i ? g.sides[i] : p;
  return p;
}

// A cell's data for the faces along axis A of the walk: phi = (v, T),
// and per tangent axis t its central of v_t (cd[t][0], the divergence)
// and of v_A (cd[t][1], the shear).
template <int NT>
struct VCell {
  float ph[4];
  float cd[NT][2];
};

// A pencil's neighbours along its tangent axes: per tangent axis, the
// slots of cell q's hi and lo neighbours, hb + q hs and lb + q ls (the
// tile's neighbour, or the facing layer's cell at the element's edge),
// their masks (1 inside, the side's eq at the edge) and the reciprocal
// of the masks' sum where it is 2 or 1.
template <int NT>
struct Tangents {
  int hb[NT], hs[NT], lb[NT], ls[NT];
  float mh[NT], ml[NT], sc[NT];
};

// The walk of one element slot x of a block (viscous_walk): per face of
// a pencil both fluxes, the advective one of walk1 (P::flux) and the
// viscous one (visc_face), from the two cells' staged rows, read once for
// both; every helper force-inlined so that the weights stay in
// registers.
template <class P, class Tl, int DIM, int EXT>
struct ViscWalk {
  using Cell = typename P::Cell;
  using VT = ViscTile<Tl, P::RS, DIM, EXT>;
  static constexpr int TE = Tl::TE, T0 = VT::T0, NT = DIM - 1;
  static constexpr int RS = P::RS, RD = P::RD, LR = VT::LR;  // T in row RS
  static constexpr int ROW = VT::NSLOT * TE;  // row stride of the staged cells
  const float* st;  // the staged cells [LR][NSLOT][TE]
  float* sd;        // D_adv (D on the last axis), Tl's layout
  float* sv;        // D_visc, Tl's layout
  const float* wv;  // my element's side weights eq, side s at wv[s E]
  int x, E;
  float surface, interior_ok, inv_h, mu, kappa;

  __device__ __forceinline__ float eq(int s) const { return __ldg(wv + s * E); }

  __device__ static __forceinline__ int vrow(int j) { return j < 3 ? 1 + j : RS; }
  // the slot of tile cell c and of cell t of side s
  __device__ static __forceinline__ int slot(int c) { return c + c / EXT; }
  __device__ static __forceinline__ int side_slot(int s, int t) { return Tl::BP + s * T0 + t; }
  // row 0 of slot sl of my element
  __device__ __forceinline__ const float* at(int sl) const { return st + sl * TE + x; }
  // the staged rows of slot sl, its phi into v.ph
  __device__ __forceinline__ void rows(int sl, float (&r)[LR], VCell<NT>& v) const {
    const float* p = at(sl);
#pragma unroll
    for (int i = 0; i < LR; ++i) r[i] = p[i * ROW];
#pragma unroll
    for (int j = 0; j < 4; ++j) v.ph[j] = r[vrow(j)];
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
  // the stride of axis A in the side layers of axis U
  __host__ __device__ static constexpr int lstride(int U, int A) {
    return t8pencil::ipow(EXT, A < U ? DIM - 2 - A : DIM - 1 - A);
  }

  // the neighbours of the pencil from c0 along A, along its tangent axes:
  // cell_dt's stencil (the outward ones from the facing layers, eq-masked)
  template <int A>
  __device__ __forceinline__ Tangents<NT> tangents(int c0) const {
    constexpr int stride = t8pencil::ipow(EXT, DIM - 1 - A), pst = stride + stride / EXT;
    Tangents<NT> tg;
    static_for<NT>([&](auto ti) {
      constexpr int TI = decltype(ti)::value;
      constexpr int TT = tangent_axis(A, TI);
      constexpr int su = t8pencil::ipow(EXT, DIM - 1 - TT), psu = su + su / EXT;
      constexpr int lst = lstride(TT, A);
      const int d = digit<TT>(c0), l0 = lidx<TT>(c0), s0 = slot(c0);
      const bool he = d == EXT - 1, le = d == 0;
      tg.hb[TI] = he ? side_slot(2 * TT, l0) : s0 + psu;
      tg.hs[TI] = he ? lst : pst;
      tg.lb[TI] = le ? side_slot(2 * TT + 1, l0) : s0 - psu;
      tg.ls[TI] = le ? lst : pst;
      tg.mh[TI] = he ? eq(2 * TT) : 1.0f;
      tg.ml[TI] = le ? eq(2 * TT + 1) : 1.0f;
      tg.sc[TI] = tg.mh[TI] + tg.ml[TI] == 2.0f ? 0.5f : 1.0f;
    });
    return tg;
  }
  // the centrals of the pencil's cell q for the faces along A (v.ph set)
  template <int A, bool EXACT>
  __device__ __forceinline__ void centrals(int q, const Tangents<NT>& tg, VCell<NT>& v) const {
    static_for<NT>([&](auto ti) {
      constexpr int TI = decltype(ti)::value;
      constexpr int TT = tangent_axis(A, TI);
      const float* hp = at(tg.hb[TI] + q * tg.hs[TI]);
      const float* lp = at(tg.lb[TI] + q * tg.ls[TI]);
      auto dt = [&](int j) {
        const float me = v.ph[j];
        return masked_dt<EXACT>(hp[vrow(j) * ROW] - me, tg.mh[TI], me - lp[vrow(j) * ROW],
                                tg.ml[TI], tg.sc[TI], inv_h);
      };
      v.cd[TI][0] = dt(TT);
      v.cd[TI][1] = dt(A);
    });
  }
  // lay_dt: one-sided at the layer's borders, from the values vm, v0, vp
  // at li - 1, li, li + 1 (those beyond a border are not used); the
  // masks' sum is 2 or 1
  __device__ __forceinline__ float lay_dt(int li, float vm, float v0, float vp) const {
    const bool up = li < EXT - 1, dn = li > 0;
    const float d_hi = up ? vp - v0 : 0.0f;
    const float d_lo = dn ? v0 - vm : 0.0f;
    const float m_hi = up ? 1.0f : 0.0f, m_lo = dn ? 1.0f : 0.0f;
    return masked_dt<true>(d_hi, m_hi, d_lo, m_lo, up && dn ? 0.5f : 1.0f, inv_h);
  }

  // the advective flux of a face, weighted, its masked speed into spd
  template <int A>
  __device__ __forceinline__ void adv_face(const Cell& cl, const Cell& cr, float wgt,
                                           float ok, const Consts& k, float& spd,
                                           float (&fw)[RD]) const {
    float f[RD];
    const float sp = P::template flux<A>(cl, cr, 0.0f, k, f);  // no auxiliary
    spd = t8pencil::nan_max(spd, sp * ok);
#pragma unroll
    for (int i = 0; i < RD; ++i) fw[i] = f[i] * wgt;
  }

  // the viscous flux rows (tau_0 .. tau_{DIM-1}, work + heat) of one face
  // along A times its weight wgt, from the two cells' phi and the face's
  // tangent derivatives of v_t (ft) and v_A (fa)
  template <int A>
  __device__ __forceinline__ void visc_face(const VCell<NT>& L, const VCell<NT>& R,
                                            const float (&ft)[NT], const float (&fa)[NT],
                                            float wgt, float (&f)[DIM + 1]) const {
    constexpr float C23 = (float)(2.0 / 3.0);
    float dn[4], vf[DIM];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dn[j] = (R.ph[j] - L.ph[j]) * inv_h;
      if (j < DIM) vf[j] = 0.5f * (L.ph[j] + R.ph[j]);
    }
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
  // an interior face: the tangent derivatives the means of the two cells'
  // centrals
  template <int A>
  __device__ __forceinline__ void visc_interior(const VCell<NT>& L, const VCell<NT>& R,
                                                float (&f)[DIM + 1]) const {
    float ft[NT], fa[NT];
#pragma unroll
    for (int ti = 0; ti < NT; ++ti) {
      ft[ti] = 0.5f * (L.cd[ti][0] + R.cd[ti][0]);
      fa[ti] = 0.5f * (L.cd[ti][1] + R.cd[ti][1]);
    }
    visc_face<A>(L, R, ft, fa, surface, f);
  }
  // a mesh face: the tangent derivatives the means of my boundary plane's
  // (cell c) and the facing layer's (side s, cell t) within-layer ones
  template <int A>
  __device__ __forceinline__ void visc_mesh(const VCell<NT>& L, const VCell<NT>& R, int c,
                                            int s, int t, float wgt,
                                            float (&f)[DIM + 1]) const {
    float ft[NT], fa[NT];
    static_for<NT>([&](auto ti) {
      constexpr int TI = decltype(ti)::value;
      constexpr int TT = tangent_axis(A, TI);
      constexpr int cs = t8pencil::ipow(EXT, DIM - 1 - TT), pcs = cs + cs / EXT;
      constexpr int ls = t8pencil::ipow(EXT, NT - 1 - TI);  // layer stride
      const int li = digit<TT>(c);
      const int om = li > 0 ? 1 : 0, op = li < EXT - 1 ? 1 : 0;  // in range
      const float* mp = at(slot(c));
      const float* lp = at(side_slot(s, t));
      auto dt = [&](int j) {
        const int r = vrow(j) * ROW;
        return 0.5f * (lay_dt(li, mp[r - om * pcs * TE], mp[r], mp[r + op * pcs * TE]) +
                       lay_dt(li, lp[r - om * ls * TE], lp[r], lp[r + op * ls * TE]));
      };
      ft[TI] = dt(TT);
      fa[TI] = dt(A);
    });
    visc_face<A>(L, R, ft, fa, wgt, f);
  }

  // D of the cell in slot sq from its lo face's (fl, flv) and hi face's
  // (fw, fv) weighted fluxes: D_adv in walk1's order, D_visc as (Dv +
  // F(c|c+1)) - F(c-1|c) from 0 on axis 0; on the last axis D = D_adv +
  // D_visc, the mass row (and m_z in 2D) + 0
  template <int A>
  __device__ __forceinline__ void update(int sq, const float (&fl)[RD], const float (&fw)[RD],
                                         const float (&flv)[DIM + 1],
                                         const float (&fv)[DIM + 1]) const {
    constexpr bool FIRST = A == 0, LAST = A == DIM - 1;
    constexpr int DR = Tl::BP * TE;  // row stride of the D tiles
    float* pd = sd + sq * TE + x;
    float* pv = sv + sq * TE + x;
    float da[RD], dv[DIM + 1];
#pragma unroll
    for (int i = 0; i < RD; ++i) da[i] = ((FIRST ? 0.0f : pd[i * DR]) + fl[i]) - fw[i];
#pragma unroll
    for (int i = 0; i <= DIM; ++i) dv[i] = ((FIRST ? 0.0f : pv[i * DR]) + fv[i]) - flv[i];
    if constexpr (LAST) {
      pd[0] = da[0] + 0.0f;
#pragma unroll
      for (int i = 0; i < DIM; ++i) pd[(1 + i) * DR] = da[1 + i] + dv[i];
      if constexpr (DIM == 2) pd[3 * DR] = da[3] + 0.0f;
      pd[4 * DR] = da[4] + dv[DIM];
    } else {
#pragma unroll
      for (int i = 0; i < RD; ++i) pd[i * DR] = da[i];
#pragma unroll
      for (int i = 0; i <= DIM; ++i) pv[i * DR] = dv[i];
    }
  }

  // walk segment seg of pencil t along A, its cells [seg Ls, (seg + 1)
  // Ls), Ls = EXT / SPLIT: each face of theirs once (the face between two
  // segments in both, the same bits), the side layers 2A+1 (lo, weight
  // w_lo) and 2A (hi, w_hi) beyond the pencil's ends.  One loop over the
  // faces, its body one face (the code of a pencil stays small).
  template <int A, bool EXACT>
  __device__ __forceinline__ void pencil(int t, int seg, float w_lo, float w_hi,
                                         const Consts& k, float& spd) const {
    constexpr int stride = t8pencil::ipow(EXT, DIM - 1 - A), pst = stride + stride / EXT;
    constexpr int Ls = EXT / Tl::SPLIT;
    const int c0 = t8pencil::pencil_start<DIM, EXT, A>(t);
    const int s0 = slot(c0);
    const Tangents<NT> tg = tangents<A>(c0);
    const float v_lo = eq(2 * A + 1) * surface, v_hi = eq(2 * A) * surface;
    const int q0 = seg * Ls;
    float r[LR];  // a cell's staged rows
    VCell<NT> L, R;
    // cell q0 - 1: the lo side layer's cell t, or the tile's
    rows(q0 == 0 ? side_slot(2 * A + 1, t) : s0 + (q0 - 1) * pst, r, L);
    if (q0 > 0) centrals<A, EXACT>(q0 - 1, tg, L);
    Cell cl = P::template cell<A>(r, k);
    float fl[RD], flv[DIM + 1];  // the weighted fluxes of cell q-1's lo face
#pragma unroll
    for (int i = 0; i < RD; ++i) fl[i] = 0.0f;
#pragma unroll
    for (int i = 0; i <= DIM; ++i) flv[i] = 0.0f;
#pragma unroll 1
    for (int q = q0; q <= q0 + Ls; ++q) {
      const bool lo = q == 0, hi = q == EXT;
      rows(hi ? side_slot(2 * A, t) : s0 + q * pst, r, R);
      if (!hi) centrals<A, EXACT>(q, tg, R);
      const Cell cr = P::template cell<A>(r, k);
      float fw[RD], fv[DIM + 1];
      adv_face<A>(cl, cr, lo ? w_lo : (hi ? w_hi : surface),
                  lo ? (w_lo > 0.0f ? 1.0f : 0.0f)
                     : (hi ? (w_hi > 0.0f ? 1.0f : 0.0f) : interior_ok),
                  k, spd, fw);
      if (lo || hi)
        visc_mesh<A>(L, R, lo ? c0 : c0 + (EXT - 1) * stride, lo ? 2 * A + 1 : 2 * A, t,
                     lo ? v_lo : v_hi, fv);
      else
        visc_interior<A>(L, R, fv);
      if (q > q0) update<A>(s0 + (q - 1) * pst, fl, fw, flv, fv);
#pragma unroll
      for (int i = 0; i < RD; ++i) fl[i] = fw[i];
#pragma unroll
      for (int i = 0; i <= DIM; ++i) flv[i] = fv[i];
      cl = cr;
      L = R;
    }
  }
};

// The advective and Navier-Stokes divergences of the block's whole
// elements (PL = EXT) in one walk per axis, D = D_adv + D_visc into sd:
// walk1's arithmetic and the tile math of _tile_viscous_divergence
// (t8gpu_tpu/ops/pallas_kernels.py:914-1086), each in its operation
// order.  Returns the thread's masked interface speed max.
//
// Staging: every load of a thread, its tile cells' rows and its side
// layers' cells' rows, in flight at once; each cell converted once into
// its fields (P::convert) and T = P::temperature(rho, p), 1/(rho/p)
// (kepes) or p/rho, into st (ViscTile's layout: the side layers' cells
// after the tile's in each row, read there by both the advective pencil
// ends and the viscous stencil).  Then per axis A, SPLIT threads walk
// each pencil along A, one segment each (ViscWalk::pencil), and evaluate
// each face once (the one between the segments twice, the same bits):
// the advective flux as walk1, and, with phi = (v, T),
//
//   dn    = (phi_R - phi_L) / h                       normal derivatives
//   dt_t  = mean of the two cells' mask-aware centrals along t (interior),
//           or of the two facing layers' within-layer derivatives (mesh)
//   tau_A = mu (2 dn_A - 2/3 (dn_A + sum_t dt_t v_t)),  tau_t = mu (dn_t + dt_t v_A)
//   F     = (0, tau, v_f . tau + kappa dn_T) w,   w = surface inside,
//           eq surface at the mesh faces
//
// into the separate accumulators D_adv (sd) and D_visc (sv), added on
// the last axis.  An element whose side weights eq are all 0 or 1 (the
// solver's) takes the centrals' quotients as products (EXACT); any other
// takes the divisions.  Every thread of the block calls it; it ends with
// a __syncthreads, after which the block reads sd.
template <class P, class Tl, int DIM, int EXT>
__device__ __forceinline__ float viscous_walk(const t8pencil::Args& g,
                                              const Physics& ph, float* st,
                                              float* sd, float* sv, int e0,
                                              const Consts& k) {
  using VW = ViscWalk<P, Tl, DIM, EXT>;
  constexpr int B = Tl::B, TE = Tl::TE, T0 = VW::T0, RIN = P::RIN, RS = P::RS;
  static_assert(B == t8pencil::ipow(EXT, DIM), "the viscous walk takes whole elements");
  constexpr int NC = B * TE / Tl::THREADS, NS = 2 * DIM * T0 * TE / Tl::THREADS;
  static_assert(NC * Tl::THREADS == B * TE && NS * Tl::THREADS == 2 * DIM * T0 * TE,
                "whole rounds of the block");
  const int x = threadIdx.x, y = threadIdx.y, tid = y * TE + x;
  const int e = e0 + x;
  const bool live = e < g.E;
  const long long Es = g.E;
  const long long rs = (long long)B * Es, ls = (long long)T0 * Es;

  VW vw{st, sd, sv, ph.wv + Es + e, x, g.E, 0.0f, 0.0f, 0.0f, ph.mu, ph.kappa};
  bool exact = true;
  if (live) {
    vw.surface = __ldg(g.w + e);
    vw.interior_ok = vw.surface > 0.0f ? 1.0f : 0.0f;
    vw.inv_h = 1.0f / __ldg(ph.wv + e);
#pragma unroll
    for (int s = 0; s < 2 * DIM; ++s) {
      const float eq = vw.eq(s);
      exact = exact && (eq == 0.0f || eq == 1.0f);
    }
  }
  // stage: the cells', then the side cells' loads, then their fields and T
  float vc[NC][RIN], vs[NS][RIN];
#pragma unroll
  for (int it = 0; it < NC; ++it) {
    const int j = it * Tl::THREADS + tid, cx = j % TE, c = j / TE;
    if (e0 + cx < g.E) {
#pragma unroll
      for (int i = 0; i < RIN; ++i) vc[it][i] = __ldg(g.u + i * rs + (long long)c * Es + e0 + cx);
    }
  }
#pragma unroll
  for (int it = 0; it < NS; ++it) {
    const int j = it * Tl::THREADS + tid, cx = j % TE, t = j / TE % T0, s = j / TE / T0;
    if (e0 + cx < g.E) {
      const float* base = side_layer<DIM>(g, s) + (long long)t * Es + e0 + cx;
#pragma unroll
      for (int i = 0; i < RIN; ++i) vs[it][i] = __ldg(base + i * ls);
    }
  }
  auto store = [&](const float* v, int sl, int cx) {
    float f[RS];
    P::convert(v, f, k);
    float* out = st + sl * TE + cx;
#pragma unroll
    for (int i = 0; i < RS; ++i) out[i * VW::ROW] = f[i];
    out[RS * VW::ROW] = P::temperature(f[0], f[4]);
  };
#pragma unroll
  for (int it = 0; it < NC; ++it) {
    const int j = it * Tl::THREADS + tid, cx = j % TE, c = j / TE;
    if (e0 + cx < g.E) store(vc[it], VW::slot(c), cx);
  }
#pragma unroll
  for (int it = 0; it < NS; ++it) {
    const int j = it * Tl::THREADS + tid, cx = j % TE, t = j / TE % T0, s = j / TE / T0;
    if (e0 + cx < g.E) store(vs[it], VW::side_slot(s, t), cx);
  }
  __syncthreads();

  // per axis the fused walk (the barriers: D changes hands between the
  // threads)
  float spd = 0.0f;
  auto axis = [&](auto a_) {
    constexpr int A = decltype(a_)::value;
    if (live) {
      const float w_hi = __ldg(g.w + (1 + 2 * A) * Es + e);
      const float w_lo = __ldg(g.w + (2 + 2 * A) * Es + e);
#pragma unroll 1
      for (int i = y; i < T0 * Tl::SPLIT; i += Tl::SLOTS) {
        if (exact)
          vw.template pencil<A, true>(i % T0, i / T0, w_lo, w_hi, k, spd);
        else
          vw.template pencil<A, false>(i % T0, i / T0, w_lo, w_hi, k, spd);
      }
    }
    __syncthreads();
  };
  axis(std::integral_constant<int, 0>{});
  axis(std::integral_constant<int, 1>{});
  if constexpr (DIM == 3) axis(std::integral_constant<int, 2>{});
  return spd;
}

// Floats of a block's staged cells: the walk's tile, or ViscTile's.
template <class P, int DIM, int EXT, int PH>
__host__ __device__ constexpr int staged_floats() {
  using Tl = StageTile<P, DIM, EXT, PH>;
  if constexpr (PH == VISCOUS)
    return ViscTile<Tl, P::RS, DIM, EXT>::STAGED;
  else
    return Tl::TILE;
}

// One stage for a block: it walks its slab of its elements' cells
// (walk1_slab; from the state, the fields derived as they are staged;
// VISCOUS: viscous_walk, both divergences on one walk per axis), then
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
  float* sd = st + staged_floats<P, DIM, EXT, PH>();  // D
  float* red = sd + Tl::DTILE;  // [SLOTS][TE] speeds

  const int slab = blockIdx.x % NSLAB;
  const int e0 = (blockIdx.x / NSLAB) * Tl::TE;
  float spd;
  if constexpr (PH == VISCOUS)
    spd = viscous_walk<P, Tl, DIM, EXT>(g, ph, st, sd, red + Tl::SLOTS * Tl::TE, e0, k);
  else
    spd = t8pencil::walk1_slab<P, Tl, DIM, EXT>(g, st, sd, slab, e0, k);

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

// Dynamic shared memory of a block: the tiles of the walk (ViscTile's
// for the viscous stage).
template <class P, int DIM, int EXT, int PH>
constexpr size_t stage_smem() {
  using Tl = StageTile<P, DIM, EXT, PH>;
  if constexpr (PH == VISCOUS)
    return (size_t)ViscTile<Tl, P::RS, DIM, EXT>::FLOATS * sizeof(float);
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
