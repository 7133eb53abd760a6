// armour_rt: native real-time runtime for the ARMOUR-class framework.
//
// The device executes the planning pipeline (JRS -> PZ FK/RNEA -> constraints ->
// NLP) as one jitted program; this library is the HOST side of the runtime:
// the 1 kHz robust CBF tracking controller and plant rollout that must run
// with microsecond latency next to the robot, where a device round-trip per
// control tick is not acceptable.  It is the native equivalent of the
// reference's mex controller stack (kinova_robust_controllers_mex/src/
// robust_controller.cpp:129-167, rnea.cpp:6-99) — same math as
// armour_tpu/controller.py and armour_tpu/rnea_numeric.py, cross-checked by
// tests/test_native_runtime.py against the JAX implementation to ~1e-10.
//
// Interval robustness bounds use the linearity of RNEA in each link's
// (mass, inertia): per-link sensitivity RNEA evaluations give an exact
// disturbance envelope (tighter than directed interval arithmetic, see
// controller.py docstring), so no interval library is needed.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 armour_rt.cpp -o libarmour_rt.so
// Python binding: armour_tpu/runtime/native.py (ctypes).

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
};

inline Vec3 v3(double x, double y, double z) { return {x, y, z}; }
inline Vec3 operator+(Vec3 a, Vec3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline Vec3 operator-(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 operator*(double s, Vec3 a) { return {s * a.x, s * a.y, s * a.z}; }
inline double dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

struct Mat3 {
  double m[9];  // row-major
  Vec3 mul(Vec3 v) const {
    return {m[0] * v.x + m[1] * v.y + m[2] * v.z,
            m[3] * v.x + m[4] * v.y + m[5] * v.z,
            m[6] * v.x + m[7] * v.y + m[8] * v.z};
  }
  Vec3 tmul(Vec3 v) const {  // transpose multiply
    return {m[0] * v.x + m[3] * v.y + m[6] * v.z,
            m[1] * v.x + m[4] * v.y + m[7] * v.z,
            m[2] * v.x + m[5] * v.y + m[8] * v.z};
  }
  Mat3 mulm(const Mat3& b) const {
    Mat3 r;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        double s = 0;
        for (int k = 0; k < 3; ++k) s += m[3 * i + k] * b.m[3 * k + j];
        r.m[3 * i + j] = s;
      }
    return r;
  }
};

// rotation about coordinate axis (1/2/3 = x/y/z) by angle q (rnea_numeric.py
// _axis_rot semantics)
Mat3 axis_rot(int axis, double q) {
  double c = std::cos(q), s = std::sin(q);
  if (axis == 1) return {{1, 0, 0, 0, c, -s, 0, s, c}};
  if (axis == 2) return {{c, 0, s, 0, 1, 0, -s, 0, c}};
  return {{c, -s, 0, s, c, 0, 0, 0, 1}};
}

}  // namespace

extern "C" {

// Serial-manipulator model, mirroring armour_tpu/robot.py RobotModel fields.
// All pointers are caller-owned row-major double arrays.
struct ArtModel {
  int num_joints;    // J (moving links)
  int num_factors;   // F (actuated joints, F <= J)
  const int* axes;   // [J] 1/2/3 = x/y/z, negative = flipped sign, 0 = fixed
  const double* trans;     // [(J+1)*3] joint origin translation in parent frame
  const double* rot_mats;  // [J*9] fixed rpy rotation per joint
  const double* mass;      // [J]
  const double* com;       // [J*3]
  const double* inertia;   // [J*9] about COM, link frame
  const double* armature;  // [J] transmission inertia
  const double* damping;   // [J]
  double gravity;          // signed z acceleration (e.g. +9.81 convention of rnea_numeric)
  double mass_uncertainty;     // fractional
  double inertia_uncertainty;  // fractional
};

// Passivity-form RNEA (Dynamics.cu:83-181 semantics; identical recursion to
// armour_tpu/rnea_numeric.py rnea).  mass/inertia override the model's
// nominal values when non-null (used for true-plant and sensitivity evals).
void art_rnea(const ArtModel* md, const double* q, const double* qd,
              const double* qd_aux, const double* qdd, const double* mass_ovr,
              const double* inertia_ovr, int set_gravity, int include_armature,
              double* tau_out) {
  const int J = md->num_joints, F = md->num_factors;
  const double* mass = mass_ovr ? mass_ovr : md->mass;
  const double* inert = inertia_ovr ? inertia_ovr : md->inertia;

  std::vector<Mat3> Rs(J);
  for (int i = 0; i < J; ++i) {
    Mat3 rpy;
    std::memcpy(rpy.m, md->rot_mats + 9 * i, sizeof(rpy.m));
    int ax = md->axes[i];
    if (ax == 0 || i >= F) {
      Rs[i] = rpy;
    } else {
      double sgn = ax > 0 ? 1.0 : -1.0;
      Rs[i] = rpy.mulm(axis_rot(ax > 0 ? ax : -ax, sgn * q[i]));
    }
  }

  Vec3 w = v3(0, 0, 0), wa = v3(0, 0, 0), wd = v3(0, 0, 0);
  Vec3 acc = v3(0, 0, set_gravity ? md->gravity : 0.0);
  std::vector<Vec3> Fv(J), Nv(J);
  for (int i = 0; i < J; ++i) {
    Vec3 tr = v3(md->trans[3 * i], md->trans[3 * i + 1], md->trans[3 * i + 2]);
    acc = Rs[i].tmul(acc + cross(wd, tr) + cross(w, cross(wa, tr)));
    w = Rs[i].tmul(w);
    wa = Rs[i].tmul(wa);
    wd = Rs[i].tmul(wd);
    int ax = md->axes[i];
    if (ax != 0 && i < F) {
      int a = (ax > 0 ? ax : -ax) - 1;
      double sgn = ax > 0 ? 1.0 : -1.0;
      Vec3 e = v3(a == 0 ? sgn : 0, a == 1 ? sgn : 0, a == 2 ? sgn : 0);
      w = w + qd[i] * e;
      wd = wd + cross(wa, qd[i] * e) + qdd[i] * e;
      wa = wa + qd_aux[i] * e;
    }
    Vec3 cb = v3(md->com[3 * i], md->com[3 * i + 1], md->com[3 * i + 2]);
    Mat3 Ib;
    std::memcpy(Ib.m, inert + 9 * i, sizeof(Ib.m));
    Fv[i] = mass[i] * (acc + cross(wd, cb) + cross(w, cross(wa, cb)));
    Nv[i] = Ib.mul(wd) + cross(wa, Ib.mul(w));
  }

  Vec3 f = v3(0, 0, 0), n = v3(0, 0, 0);
  for (int i = J - 1; i >= 0; --i) {
    Mat3 Rip1;
    if (i + 1 < J) {
      Rip1 = Rs[i + 1];
    } else {
      Rip1 = Mat3{{1, 0, 0, 0, 1, 0, 0, 0, 1}};
    }
    Vec3 cb = v3(md->com[3 * i], md->com[3 * i + 1], md->com[3 * i + 2]);
    Vec3 tr1 = v3(md->trans[3 * (i + 1)], md->trans[3 * (i + 1) + 1],
                  md->trans[3 * (i + 1) + 2]);
    Vec3 rf = Rip1.mul(f);
    n = Nv[i] + Rip1.mul(n) + cross(cb, Fv[i]) + cross(tr1, rf);
    f = rf + Fv[i];
    int ax = md->axes[i];
    if (ax != 0 && i < F) {
      int a = (ax > 0 ? ax : -ax) - 1;
      double tau = (a == 0) ? n.x : (a == 1) ? n.y : n.z;
      if (include_armature) tau += md->armature[i] * qdd[i];
      if (md->damping[i] != 0.0) tau += md->damping[i] * qd[i];
      tau_out[i] = tau;
    }
  }
}

namespace {

// sum over the 2J per-link uncertainty directions of |tau| sensitivities
// (controller.py _perturbation_taus): mass directions keep gravity scaling,
// inertia directions carry no mass.
void perturbation_abs_sum(const ArtModel* md, const double* q, const double* qd,
                          const double* qd_aux, const double* qdd,
                          double* abs_sum /* [F] */,
                          std::vector<std::vector<double>>* raw /* optional */) {
  const int J = md->num_joints, F = md->num_factors;
  std::vector<double> zero_mass(J, 0.0), zero_inertia(9 * J, 0.0);
  std::vector<double> mass_dir(J), inertia_dir(9 * J);
  std::vector<double> tau(F);
  for (int i = 0; i < F; ++i) abs_sum[i] = 0.0;
  for (int l = 0; l < J; ++l) {
    // mass direction: e_l * mass_l * uncertainty, zero inertia
    std::fill(mass_dir.begin(), mass_dir.end(), 0.0);
    mass_dir[l] = md->mass[l] * md->mass_uncertainty;
    art_rnea(md, q, qd, qd_aux, qdd, mass_dir.data(), zero_inertia.data(),
             /*set_gravity=*/1, /*include_armature=*/0, tau.data());
    for (int i = 0; i < F; ++i) abs_sum[i] += std::fabs(tau[i]);
    if (raw) raw->push_back(tau);
    // inertia direction: link-l inertia scaled by uncertainty, zero mass
    std::fill(inertia_dir.begin(), inertia_dir.end(), 0.0);
    for (int k = 0; k < 9; ++k)
      inertia_dir[9 * l + k] = md->inertia[9 * l + k] * md->inertia_uncertainty;
    art_rnea(md, q, qd, qd_aux, qdd, zero_mass.data(), inertia_dir.data(),
             /*set_gravity=*/1, /*include_armature=*/0, tau.data());
    for (int i = 0; i < F; ++i) abs_sum[i] += std::fabs(tau[i]);
    if (raw) raw->push_back(tau);
  }
}

}  // namespace

// Robust passivity/CBF control update (uarmtd_robust_CBF_LLC.m:58-189 /
// robust_controller.cpp:129-167 semantics, matching controller.py
// robust_control exactly).  q/qd/refs are length-F arrays.
void art_robust_control(const ArtModel* md, double kr, double alpha,
                        double v_max, const double* q, const double* qd,
                        const double* q_des, const double* qd_des,
                        const double* qdd_des, double* u_out, double* tau_out,
                        double* v_out) {
  const int F = md->num_factors;
  std::vector<double> r(F), qd_ref(F), qdd_ref(F), zero(F, 0.0);
  for (int i = 0; i < F; ++i) {
    double err = q_des[i] - q[i], derr = qd_des[i] - qd[i];
    qd_ref[i] = qd_des[i] + kr * err;
    qdd_ref[i] = qdd_des[i] + kr * derr;
    r[i] = derr + kr * err;
  }

  art_rnea(md, q, qd, qd_ref.data(), qdd_ref.data(), nullptr, nullptr, 1, 1,
           tau_out);

  // disturbance bound rho = |r| . sum_l |tau_sensitivity_l|
  std::vector<double> dist_sup(F);
  perturbation_abs_sum(md, q, qd, qd_ref.data(), qdd_ref.data(),
                       dist_sup.data(), nullptr);
  double rho = 0.0, r_sq = 0.0;
  for (int i = 0; i < F; ++i) {
    rho += std::fabs(r[i]) * dist_sup[i];
    r_sq += r[i] * r[i];
  }

  // interval Lyapunov V = sup 0.5 r^T M(q) r via RNEA(qdd=r, no gravity).
  // M includes the transmission inertia (the plant is M_links+diag(armature);
  // the reference's passRNEA adds transI*qdd inside this call too) — without
  // it V is underestimated and the CBF fires too late (controller.py note).
  std::vector<double> mr(F);
  art_rnea(md, q, zero.data(), zero.data(), r.data(), nullptr, nullptr,
           /*set_gravity=*/0, /*include_armature=*/1, mr.data());
  double v_nom = 0.0;
  for (int i = 0; i < F; ++i) v_nom += 0.5 * r[i] * mr[i];
  std::vector<std::vector<double>> raw;
  std::vector<double> dummy(F);
  // sensitivities of M r need per-direction signs of (pert . r), so use raw
  {
    const int J = md->num_joints;
    raw.reserve(2 * J);
    std::vector<double> zg(F, 0.0);
    // reuse helper but with set_gravity=0 semantics: inline here
    std::vector<double> zero_mass(J, 0.0), zero_inertia(9 * J, 0.0);
    std::vector<double> mass_dir(J), inertia_dir(9 * J), tau(F);
    for (int l = 0; l < J; ++l) {
      std::fill(mass_dir.begin(), mass_dir.end(), 0.0);
      mass_dir[l] = md->mass[l] * md->mass_uncertainty;
      art_rnea(md, q, zg.data(), zg.data(), r.data(), mass_dir.data(),
               zero_inertia.data(), /*set_gravity=*/1, 0, tau.data());
      raw.push_back(tau);
      std::fill(inertia_dir.begin(), inertia_dir.end(), 0.0);
      for (int k = 0; k < 9; ++k)
        inertia_dir[9 * l + k] =
            md->inertia[9 * l + k] * md->inertia_uncertainty;
      art_rnea(md, q, zg.data(), zg.data(), r.data(), zero_mass.data(),
               inertia_dir.data(), /*set_gravity=*/1, 0, tau.data());
      raw.push_back(tau);
    }
  }
  double v_pert = 0.0;
  for (const auto& t : raw) {
    double s = 0.0;
    for (int i = 0; i < F; ++i) s += t[i] * r[i];
    v_pert += std::fabs(s);
  }
  double v_sup = v_nom + 0.5 * v_pert;
  double h = v_max - v_sup;

  double lam = (-alpha * h + rho) / (r_sq > 1e-12 ? r_sq : 1e-12);
  if (lam < 0.0) lam = 0.0;
  for (int i = 0; i < F; ++i) {
    double vi = lam * r[i];
    v_out[i] = vi;
    u_out[i] = tau_out[i] + (r_sq > 0.0 ? vi : 0.0);
  }
}

namespace {

// LU factorization with partial pivoting (in place) + solve, for the 7x7
// mass matrix.
struct LU {
  int n;
  std::vector<double> a;
  std::vector<int> piv;
  void factor(std::vector<double> M, int F) {
    n = F;
    a = std::move(M);
    piv.resize(n);
    for (int c = 0; c < n; ++c) {
      int p = c;
      for (int r = c + 1; r < n; ++r)
        if (std::fabs(a[r * n + c]) > std::fabs(a[p * n + c])) p = r;
      piv[c] = p;
      if (p != c)
        for (int k = 0; k < n; ++k) std::swap(a[c * n + k], a[p * n + k]);
      double d = a[c * n + c];
      for (int r = c + 1; r < n; ++r) {
        double fac = a[r * n + c] / d;
        a[r * n + c] = fac;
        for (int k = c + 1; k < n; ++k) a[r * n + k] -= fac * a[c * n + k];
      }
    }
  }
  void solve(const double* rhs, double* x) const {
    std::vector<double> y(rhs, rhs + n);
    for (int c = 0; c < n; ++c)
      if (piv[c] != c) std::swap(y[c], y[piv[c]]);
    for (int r = 0; r < n; ++r)
      for (int k = 0; k < r; ++k) y[r] -= a[r * n + k] * y[k];
    for (int r = n - 1; r >= 0; --r) {
      for (int k = r + 1; k < n; ++k) y[r] -= a[r * n + k] * y[k];
      y[r] /= a[r * n + r];
    }
    std::memcpy(x, y.data(), n * sizeof(double));
  }
};

// M(q) via F unit-acceleration RNEA columns (rnea_mass.m, armature on diag).
void mass_matrix_native(const ArtModel* md, const double* true_mass,
                        const double* true_inertia, const double* q,
                        std::vector<double>* M_out) {
  const int F = md->num_factors;
  std::vector<double> col(F), e(F), zero(F, 0.0);
  M_out->assign(F * F, 0.0);
  for (int j = 0; j < F; ++j) {
    std::fill(e.begin(), e.end(), 0.0);
    e[j] = 1.0;
    art_rnea(md, q, zero.data(), zero.data(), e.data(), true_mass,
             true_inertia, /*set_gravity=*/0, /*include_armature=*/1,
             col.data());
    for (int i = 0; i < F; ++i) (*M_out)[i * F + j] = col[i];
  }
}

// qdd = M^-1 (u - bias(q, qd)) with a PRE-FACTORED mass matrix — matching
// simulator.py make_rollout, which holds M fixed across the RK4 stages of a
// control tick (M varies slowly) and re-evaluates only the bias.
void plant_accel_lu(const ArtModel* md, const double* true_mass,
                    const double* true_inertia, const LU& lu, const double* q,
                    const double* qd, const double* u, double* qdd_out) {
  const int F = md->num_factors;
  std::vector<double> zero(F, 0.0), bias(F), rhs(F);
  art_rnea(md, q, qd, qd, zero.data(), true_mass, true_inertia, 1, 0,
           bias.data());
  for (int i = 0; i < F; ++i) rhs[i] = u[i] - bias[i];
  lu.solve(rhs.data(), qdd_out);
}

}  // namespace

// Closed-loop tracking rollout: integrate the true plant under the robust
// CBF controller with zero-order-hold control at dt and RK4 substeps —
// the native twin of armour_tpu/simulator.py make_rollout (uarmtd_agent.m
// move/dynamics semantics).  Reference arrays are per-control-tick
// [n_steps * F].  Logs are written per tick (post-step state + input).
void art_rollout(const ArtModel* md, const double* true_mass,
                 const double* true_inertia, double kr, double alpha,
                 double v_max, double dt, int substeps, int n_steps,
                 const double* q0, const double* qd0, const double* q_des,
                 const double* qd_des, const double* qdd_des, double* q_log,
                 double* qd_log, double* u_log) {
  const int F = md->num_factors;
  std::vector<double> q(q0, q0 + F), qd(qd0, qd0 + F);
  std::vector<double> u(F), tau(F), v(F);
  std::vector<double> k1q(F), k1v(F), k2q(F), k2v(F), k3q(F), k3v(F), k4q(F),
      k4v(F), tq(F), tv(F);
  std::vector<double> M;
  LU lu;
  for (int s = 0; s < n_steps; ++s) {
    art_robust_control(md, kr, alpha, v_max, q.data(), qd.data(),
                       q_des + s * F, qd_des + s * F, qdd_des + s * F,
                       u.data(), tau.data(), v.data());
    mass_matrix_native(md, true_mass, true_inertia, q.data(), &M);
    lu.factor(M, F);
    double h = dt / substeps;
    for (int sub = 0; sub < substeps; ++sub) {
      // RK4: k1
      plant_accel_lu(md, true_mass, true_inertia, lu, q.data(), qd.data(),
                     u.data(), k1v.data());
      for (int i = 0; i < F; ++i) k1q[i] = qd[i];
      // k2
      for (int i = 0; i < F; ++i) {
        tq[i] = q[i] + 0.5 * h * k1q[i];
        tv[i] = qd[i] + 0.5 * h * k1v[i];
      }
      plant_accel_lu(md, true_mass, true_inertia, lu, tq.data(), tv.data(),
                     u.data(), k2v.data());
      for (int i = 0; i < F; ++i) k2q[i] = tv[i];
      // k3
      for (int i = 0; i < F; ++i) {
        tq[i] = q[i] + 0.5 * h * k2q[i];
        tv[i] = qd[i] + 0.5 * h * k2v[i];
      }
      plant_accel_lu(md, true_mass, true_inertia, lu, tq.data(), tv.data(),
                     u.data(), k3v.data());
      for (int i = 0; i < F; ++i) k3q[i] = tv[i];
      // k4
      for (int i = 0; i < F; ++i) {
        tq[i] = q[i] + h * k3q[i];
        tv[i] = qd[i] + h * k3v[i];
      }
      plant_accel_lu(md, true_mass, true_inertia, lu, tq.data(), tv.data(),
                     u.data(), k4v.data());
      for (int i = 0; i < F; ++i) k4q[i] = tv[i];
      for (int i = 0; i < F; ++i) {
        q[i] += (h / 6.0) * (k1q[i] + 2 * k2q[i] + 2 * k3q[i] + k4q[i]);
        qd[i] += (h / 6.0) * (k1v[i] + 2 * k2v[i] + 2 * k3v[i] + k4v[i]);
      }
    }
    for (int i = 0; i < F; ++i) {
      q_log[s * F + i] = q[i];
      qd_log[s * F + i] = qd[i];
      u_log[s * F + i] = u[i];
    }
  }
}

}  // extern "C"
