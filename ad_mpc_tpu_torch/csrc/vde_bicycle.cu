// The bicycle family of the VDE sweep and its RK4 map (vde.cuh): the
// blended bicycle of configs c2 and the AD path (BicycleDyn) and the
// Pacejka bicycle of config c4 (PacejkaDyn, a functor with team traits).

#ifndef PACEJKA_ROW_TEAM
#define PACEJKA_ROW_TEAM 1
#endif
#ifndef PACEJKA_ROW_WARPS
#define PACEJKA_ROW_WARPS 4
#endif
#ifndef PACEJKA_MIN_BLOCKS
#define PACEJKA_MIN_BLOCKS 1
#endif

#include "vde_models.cuh"

// The bicycle with the blend switch taken from p[0].
struct BicycleDyn {
  static constexpr int NX = 7, NU = 2, NP = 1;
  static constexpr int ROW_WARPS = 4;
  static constexpr bool STAGES = false;
  using Ctx = const float*;
  BicycleParamsC P;

  DI Ctx context(const float* p) const { return p; }

  template <class T>
  DI void operator()(const T* x, const T* u, const float* p, T* xd) const {
    bicycle_xdot(P, p[0], x, u, xd);
  }
};

struct PacejkaParamsC {  // by value from the wrapper (models/pacejka.py)
  float mass, l_f, l_r, iz, b_f, c_f, d_f, b_r, c_r, d_r, g, wheelbase;
};

// The Pacejka magic-formula bicycle with road topography
// (ad_mpc_tpu/models/pacejka.py:38-116, pacejka_dynamics_p with the 5-entry
// p = [mu, pitch, roll, B scale, D scale]), same order of operations, atanf
// where the reference has atan_mosaic. What depends on p alone (the normal
// loads, the magic formula's B and mu F_z D, the gravity feed-through) is
// computed once per thread in float. With ROW_TEAM = 1 (the committed
// default) the sweep runs a thread per row with all 9 tangents; with
// ROW_TEAM > 1 (the measured variants of experiments/bicycle_kernels.py) a
// team of lanes per row (vde.cuh: vde_team), the 9 tangent columns split
// across them in one pass: every lane builds the context from its
// scenario's p and carries the primal in lockstep with the same float
// arithmetic, so that max_(v_x, 0.5) takes one branch across the team.
// Every lane then repeats the primal's 4 atanf, 3 sincosf and 5 divisions,
// which outweigh a column's tangents: the team lost on the H100, whatever
// warps per SM its register cap bought (PERF.md).
struct PacejkaDyn {
  static constexpr int NX = 7, NU = 2, NP = 5;
  static constexpr int ROW_TEAM = PACEJKA_ROW_TEAM;
  static constexpr int ROW_WARPS = PACEJKA_ROW_WARPS;
  static constexpr int MIN_BLOCKS = PACEJKA_MIN_BLOCKS;
  static constexpr bool STAGES = false;
  struct Ctx {
    float b_f, b_r;      // B front and rear
    float k_f, k_r;      // (mu F_z) D front and rear
    float a_grav_x, a_grav_y;
  };
  PacejkaParamsC P;

  DI Ctx context(const float* p) const {
    const float mu = p[0];
    float s_pitch, c_pitch, s_roll, c_roll;
    sincosf(p[1], &s_pitch, &c_pitch);
    sincosf(p[2], &s_roll, &c_roll);
    const float g_eff = P.g * c_pitch * c_roll;
    const float fz_f = divide(P.mass * g_eff * P.l_r, P.wheelbase);
    const float fz_r = divide(P.mass * g_eff * P.l_f, P.wheelbase);
    Ctx c;
    c.b_f = P.b_f * p[3];
    c.b_r = P.b_r * p[3];
    c.k_f = mu * fz_f * (P.d_f * p[4]);
    c.k_r = mu * fz_r * (P.d_r * p[4]);
    c.a_grav_x = -P.g * s_pitch;
    c.a_grav_y = P.g * s_roll;
    return c;
  }

  template <class T>
  DI void operator()(const T* x, const T* u, const Ctx& c, T* xd) const {
    const T& psi = x[2];
    const T& v_x = x[3];
    const T& v_y = x[4];
    const T& psi_dot = x[5];
    const T& delta = x[6];
    const T& a_cmd = u[0];
    const T& delta_dot = u[1];

    const T v_x_safe = max_(v_x, 0.5f);
    const T alpha_f = delta - atan_(divide(v_y + P.l_f * psi_dot, v_x_safe));
    const T alpha_r = -atan_(divide(v_y - P.l_r * psi_dot, v_x_safe));
    T mf, mr, unused;
    sin_cos(P.c_f * atan_(c.b_f * alpha_f), mf, unused);
    sin_cos(P.c_r * atan_(c.b_r * alpha_r), mr, unused);
    const T f_fy = c.k_f * mf;
    const T f_ry = c.k_r * mr;

    T sps, cps;
    sin_cos(psi, sps, cps);
    xd[0] = v_x * cps - v_y * sps;
    xd[1] = v_x * sps + v_y * cps;
    xd[2] = psi_dot;

    T sd, cd;
    sin_cos(delta, sd, cd);
    xd[3] = a_cmd + c.a_grav_x - divide(f_fy * sd, P.mass) + v_y * psi_dot;
    xd[4] = divide(f_ry + f_fy * cd, P.mass) + c.a_grav_y - v_x * psi_dot;
    xd[5] = divide(P.l_f * f_fy * cd - P.l_r * f_ry, P.iz);
    xd[6] = delta_dot;
  }
};

extern "C" {

VDE_ENTRIES(bicycle, BicycleDyn, BicycleParamsC)
VDE_TEAM_ENTRIES(pacejka, PacejkaDyn, PacejkaParamsC)

// At the library's first load: PacejkaDyn's team sweep its block tile.
int vde_prepare() { return (int)prepare_team<PacejkaDyn>(); }

VDE_ERROR_STRING

}  // extern "C"
