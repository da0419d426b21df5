// K3: the sliding window's Gauss-Newton on Hopper, all iterations in one
// launch.
//
// It replaces no TPU kernel: the JAX package
// (dliom_tpu/imu/window_optimizer.py::optimize) leaves this loop to XLA,
// and the plain PyTorch version (`optimize_plain`) runs it as ~1,590 small
// kernels an iteration. Per lane (one block each), per iteration, exactly
// what `optimize_plain` does:
//   1. the residuals of `_all_residuals` at the current window: the head
//      prior, the W-1 IMU factors (with `bias_corrected_deltas`), the W
//      pose priors and the W gravity factors, each under its masks;
//   2. their Jacobian at delta = 0 under `_states_apply_delta`, by forward
//      dual numbers through the same expressions `torch.func.jacfwd`
//      differentiates (`Dual` below: each thread carries one tangent);
//   3. the `active_mask` column mask; 4. J^T J and J^T r;
//   5. Jacobi scaling (diagonal clamped at 1e-12) and 1e-5 I;
//   6. Cholesky and the two triangular solves;
//   7. the guards in order: active mask, isfinite, clamp to +-1;
//   8. the left-multiplicative retraction and quat_normalize.
// All float32, as the plain version is.
//
// What bounds it: neither bytes (~7 KB a lane in, 0.3 KB out) nor FLOP
// (~0.8 MFLOP a lane and iteration in the dense form): a chain of
// `iterations` dependent steps, each a Jacobian, a normal matrix, a
// Cholesky of n = 15W columns, one column after the other, and two
// triangular solves. Design: the window never leaves the block's shared
// memory between iterations, and each phase is spread over what can run
// at once:
//   * the Jacobian a column and a factor at a time (a key's column
//     touches its own block of rows and the next key's IMU rows, nothing
//     else): 3n work items, part-major so that a warp takes one path;
//   * rows kept key by key (24 a key: its prior or IMU factor, its pose
//     prior, its gravity factor), so J^T J is block tridiagonal in 15 x 15
//     blocks and its products run only over the rows two columns share,
//     4 x 4 register tiles of it a thread;
//   * the Cholesky and both solves in one warp, in registers, a 15 x 15
//     block at a time with the columns passed by shuffles
//     (`block_cholesky_solve`): no block-wide barrier inside the chain.
// Entries outside the band are exact zeros in the dense plain version too,
// so the band changes no value; sums run in another order than cuBLAS's
// and cuSOLVER's, and quotients go through one reciprocal, so the result
// agrees with the plain version to the solve's conditioning
// (test_torch_window.py's docstring), not bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kKeyDim = 15;
constexpr int kRowsPerKey = 24;  // own factor 15, pose prior 6, gravity 3
constexpr int kThreads = 256;
constexpr float kEps = 1e-12f;

// The kernel's inputs, in WindowState's field order (imu/window_optimizer.py).
enum Input {
  IN_Q, IN_P, IN_V, IN_BA, IN_BG, IN_OBS_Q, IN_OBS_T, IN_OBS_DRIFT, IN_OBS_VALID,
  IN_PRE_P, IN_PRE_Q, IN_PRE_V, IN_PRE_JAC, IN_PRE_SQRT_INFO, IN_PRE_BA, IN_PRE_BG,
  IN_PRE_DT, IN_GRAV_DIR, IN_GRAV_VALID, IN_PRIOR_SQRT_INFO, IN_PRIOR_Q, IN_PRIOR_P,
  IN_PRIOR_V, IN_PRIOR_BA, IN_PRIOR_BG, IN_NUM_KEYS, NUM_INPUTS
};
enum Output { OUT_Q, OUT_P, OUT_V, OUT_BA, OUT_BG, NUM_OUTPUTS };
enum Param {
  PAR_GRAVITY, PAR_ACC_BIAS_NOISE, PAR_GYR_BIAS_NOISE, PAR_POSE_T, PAR_POSE_T_DRIFT,
  PAR_POSE_R, PAR_POSE_R_DRIFT, PAR_GRAVITY_NOISE, NUM_PARAMS
};

struct Args {
  const void* in[NUM_INPUTS];
  float* out[NUM_OUTPUTS];
  float par[NUM_PARAMS];
};

// ----- forward dual numbers: value and one tangent -----

struct Dual {
  float v, t;
};

__device__ __forceinline__ Dual dc(float x) { return {x, 0.0f}; }
__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.t + b.t}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.t - b.t}; }
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.t}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) { return {a.v * b.v, a.v * b.t + a.t * b.v}; }
__device__ __forceinline__ Dual operator*(float s, Dual a) { return {s * a.v, s * a.t}; }
// Quotients by one reciprocal: an IEEE division is a sequence of
// dependent instructions on the card, the Jacobian's longest chain.
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float rb = 1.0f / b.v;
  const float q = a.v * rb;
  return {q, (a.t - q * b.t) * rb};
}
__device__ __forceinline__ Dual operator/(Dual a, float s) {
  const float rs = 1.0f / s;
  return {a.v * rs, a.t * rs};
}
__device__ __forceinline__ Dual operator/(float s, Dual b) {
  const float rb = 1.0f / b.v;
  const float q = s * rb;
  return {q, -q * b.t * rb};
}
__device__ __forceinline__ Dual dsqrt(Dual a) {
  const float s = sqrtf(a.v);
  return {s, a.t / (2.0f * s)};
}
__device__ __forceinline__ Dual dsin(Dual a) { return {sinf(a.v), cosf(a.v) * a.t}; }
__device__ __forceinline__ Dual dcos(Dual a) { return {cosf(a.v), -sinf(a.v) * a.t}; }
__device__ __forceinline__ Dual datan2(Dual y, Dual x) {
  const float den = x.v * x.v + y.v * y.v;
  return {atan2f(y.v, x.v), (x.v * y.t - y.v * x.t) / den};
}
// torch.clamp(x, min=lo): the tangent passes where x >= lo; NaN stays NaN
__device__ __forceinline__ Dual dclamp_min(Dual a, float lo) {
  if (a.v >= lo) return a;
  return {a.v < lo ? lo : a.v, 0.0f};
}
__device__ __forceinline__ Dual dclamp(Dual a, float lo, float hi) {
  if (a.v >= lo && a.v <= hi) return a;
  return {a.v < lo ? lo : (a.v > hi ? hi : a.v), 0.0f};
}

struct Vec3 {
  Dual x[3];
};
struct Quat {
  Dual x[4];  // w, x, y, z
};

__device__ __forceinline__ Vec3 vconst(const float* s) { return {{dc(s[0]), dc(s[1]), dc(s[2])}}; }
__device__ __forceinline__ Vec3 vadd(Vec3 a, Vec3 b) {
  return {{a.x[0] + b.x[0], a.x[1] + b.x[1], a.x[2] + b.x[2]}};
}
__device__ __forceinline__ Vec3 vsub(Vec3 a, Vec3 b) {
  return {{a.x[0] - b.x[0], a.x[1] - b.x[1], a.x[2] - b.x[2]}};
}
__device__ __forceinline__ Vec3 vscale(Vec3 a, Dual s) { return {{a.x[0] * s, a.x[1] * s, a.x[2] * s}}; }
__device__ __forceinline__ Dual vsumsq(Vec3 a) { return a.x[0] * a.x[0] + a.x[1] * a.x[1] + a.x[2] * a.x[2]; }
// rigid.py::_cross
__device__ __forceinline__ Vec3 vcross(Vec3 a, Vec3 b) {
  return {{a.x[1] * b.x[2] - a.x[2] * b.x[1], a.x[2] * b.x[0] - a.x[0] * b.x[2],
           a.x[0] * b.x[1] - a.x[1] * b.x[0]}};
}

__device__ __forceinline__ Quat qconst(const float* s) { return {{dc(s[0]), dc(s[1]), dc(s[2]), dc(s[3])}}; }
// rigid.py::quat_multiply
__device__ __forceinline__ Quat qmul(Quat a, Quat b) {
  const Dual aw = a.x[0], ax = a.x[1], ay = a.x[2], az = a.x[3];
  const Dual bw = b.x[0], bx = b.x[1], by = b.x[2], bz = b.x[3];
  return {{aw * bw - ax * bx - ay * by - az * bz, aw * bx + ax * bw + ay * bz - az * by,
           aw * by - ax * bz + ay * bw + az * bx, aw * bz + ax * by - ay * bx + az * bw}};
}
__device__ __forceinline__ Quat qconj(Quat q) { return {{q.x[0], -q.x[1], -q.x[2], -q.x[3]}}; }
// rigid.py::quat_normalize: q / clamp(sqrt(sum(q * q)), min=1e-12)
__device__ __forceinline__ Quat qnormalize(Quat q) {
  const Dual inv = 1.0f / dclamp_min(
      dsqrt(q.x[0] * q.x[0] + q.x[1] * q.x[1] + q.x[2] * q.x[2] + q.x[3] * q.x[3]), kEps);
  return {{q.x[0] * inv, q.x[1] * inv, q.x[2] * inv, q.x[3] * inv}};
}
// rigid.py::quat_rotate: v + 2 (w (u x v) + u x (u x v))
__device__ __forceinline__ Vec3 qrotate(Quat q, Vec3 v) {
  const Vec3 u = {{q.x[1], q.x[2], q.x[3]}};
  const Vec3 uv = vcross(u, v);
  const Vec3 uuv = vcross(u, uv);
  Vec3 out;
  for (int i = 0; i < 3; ++i) out.x[i] = v.x[i] + 2.0f * (q.x[0] * uv.x[i] + uuv.x[i]);
  return out;
}
__device__ __forceinline__ Vec3 qinvrotate(Quat q, Vec3 v) { return qrotate(qconj(q), v); }
// rigid.py::quat_from_axis_angle
__device__ __forceinline__ Quat qexp(Vec3 aa) {
  const Dual angle_sq = vsumsq(aa);
  const Dual angle = dsqrt(dclamp_min(angle_sq, kEps));
  const Dual half = 0.5f * angle;
  const bool small = angle_sq.v < 1e-10f;
  const Dual k = small ? dc(0.5f) - angle_sq / 48.0f : dsin(half) / angle;
  const Dual w = small ? dc(1.0f) - angle_sq / 8.0f : dcos(half);
  return {{w, k * aa.x[0], k * aa.x[1], k * aa.x[2]}};
}
// rigid.py::quat_to_axis_angle
__device__ __forceinline__ Vec3 qlog(Quat q) {
  q = qnormalize(q);
  if (q.x[0].v < 0.0f) q = {{-q.x[0], -q.x[1], -q.x[2], -q.x[3]}};
  const Dual w = dclamp(q.x[0], -1.0f, 1.0f);
  const Vec3 v = {{q.x[1], q.x[2], q.x[3]}};
  const Dual vn_sq = vsumsq(v);
  const Dual vn = dsqrt(dclamp_min(vn_sq, kEps));
  const Dual angle = 2.0f * datan2(vn, w);
  const Dual k = vn_sq.v < 1e-12f ? 2.0f / dclamp_min(w, kEps) : angle / vn;
  return vscale(v, k);
}
// rigid.py::quat_remove_yaw: Rz(-yaw(q)) q, yaw from q's rotated x axis
__device__ __forceinline__ Quat qremove_yaw(Quat q) {
  const Vec3 ex = {{dc(1.0f), dc(0.0f), dc(0.0f)}};
  const Vec3 d = qrotate(q, ex);
  const Dual half = 0.5f * (-datan2(d.x[1], d.x[0]));
  const Quat rz = {{dcos(half), dc(0.0f), dc(0.0f), dsin(half)}};
  return qmul(rz, q);
}

// ----- the block's shared memory -----

// Floats of each per-key and per-lane array in shared memory.
constexpr int kKeyFloats = 4 + 3 + 3 + 3 + 3;  // q p v ba bg
// obs_q 4, obs_t 3, pre_p 3, pre_q 4, pre_v 3, pre_jac rows 0-8 x cols 9-14
// (54), pre_sqrt_info 81, pre_ba 3, pre_bg 3, pre_dt 1, grav_dir 3, flags 3
constexpr int kFactorFloats = 4 + 3 + 3 + 4 + 3 + 54 + 81 + 3 + 3 + 1 + 3 + 3;
constexpr int kPriorFloats = 225 + 4 + 3 + 3 + 3 + 3;

__host__ __device__ __forceinline__ int ld_j(int w) { return kRowsPerKey * w + 1; }
__host__ __device__ __forceinline__ int ld_h(int w) { return kKeyDim * w + 1; }

__host__ __device__ __forceinline__ int smem_floats(int w) {
  const int n = kKeyDim * w;
  return w * (kKeyFloats + kFactorFloats) + kPriorFloats + kRowsPerKey * w  // state, factors, r
         + n * ld_j(w) + n * ld_h(w) + 4 * n;                              // J^T, H, g, inv, y, x
}

struct Smem {
  float *q, *p, *v, *ba, *bg;                         // the window, (W, 4|3)
  float *obs_q, *obs_t, *pre_p, *pre_q, *pre_v;        // per key
  float *jac, *sqrt_info, *pre_ba, *pre_bg, *dt, *grav_dir;
  float *drift, *obs_valid, *grav_valid;
  float *prior_info, *prior_q, *prior_p, *prior_v, *prior_ba, *prior_bg;
  float *r;   // (24W) residuals, rows key by key
  float *jt;  // (15W, ld_j) J^T
  float *h;   // (15W, ld_h) J^T J, its lower band, then its Cholesky factor off the diagonal
  float *g, *inv, *y, *x;  // J^T r, Jacobi 1 / d, the solves, delta (1 / L_kk first)
};

__device__ Smem carve(float* base, int w) {
  const int n = kKeyDim * w;
  Smem s;
  float* at = base;
  auto take = [&](int count) {
    float* p = at;
    at += count;
    return p;
  };
  s.q = take(4 * w);
  s.p = take(3 * w);
  s.v = take(3 * w);
  s.ba = take(3 * w);
  s.bg = take(3 * w);
  s.obs_q = take(4 * w);
  s.obs_t = take(3 * w);
  s.pre_p = take(3 * w);
  s.pre_q = take(4 * w);
  s.pre_v = take(3 * w);
  s.jac = take(54 * w);
  s.sqrt_info = take(81 * w);
  s.pre_ba = take(3 * w);
  s.pre_bg = take(3 * w);
  s.dt = take(w);
  s.grav_dir = take(3 * w);
  s.drift = take(w);
  s.obs_valid = take(w);
  s.grav_valid = take(w);
  s.prior_info = take(225);
  s.prior_q = take(4);
  s.prior_p = take(3);
  s.prior_v = take(3);
  s.prior_ba = take(3);
  s.prior_bg = take(3);
  s.r = take(kRowsPerKey * w);
  s.jt = take(n * ld_j(w));
  s.h = take(n * ld_h(w));
  s.g = take(n);
  s.inv = take(n);
  s.y = take(n);
  s.x = take(n);
  return s;
}

// ----- the factors, as dual numbers -----

struct Key {
  Quat q;
  Vec3 p, v, ba, bg;
};

// Key k of `_states_apply_delta(state, delta)` at delta = 0, the tangent
// along delta's component 15 k + j (j < 0: none).
__device__ Key key_at(const Smem& s, int k, int j) {
  Dual d[kKeyDim];
  for (int c = 0; c < kKeyDim; ++c) d[c] = {0.0f, c == j ? 1.0f : 0.0f};
  const Quat dq = qexp({{d[3], d[4], d[5]}});
  Key key;
  key.q = qnormalize(qmul(dq, qconst(s.q + 4 * k)));
  for (int i = 0; i < 3; ++i) {
    key.p.x[i] = dc(s.p[3 * k + i]) + d[i];
    key.v.x[i] = dc(s.v[3 * k + i]) + d[6 + i];
    key.ba.x[i] = dc(s.ba[3 * k + i]) + d[9 + i];
    key.bg.x[i] = dc(s.bg[3 * k + i]) + d[12 + i];
  }
  return key;
}

// sum(block * x) over the 3 columns of pre_jac[i][r0:r0+3, c0:c0+3]
__device__ __forceinline__ Vec3 mv(const float* jac, int r0, int c0, Vec3 x) {
  Vec3 out;
  for (int r = 0; r < 3; ++r) {
    const float* row = jac + (r0 + r) * 6 + (c0 - 9);
    out.x[r] = dc(row[0]) * x.x[0] + dc(row[1]) * x.x[1] + dc(row[2]) * x.x[2];
  }
  return out;
}

// `_imu_residuals` row of factor i (keys a = i - 1, b = i), 15 rows.
__device__ void imu_rows(const Smem& s, const float* par, int i, const Key& a, const Key& b,
                         Dual* out) {
  const float* jac = s.jac + 54 * i;
  const float dt = s.dt[i];
  const Vec3 g = {{dc(0.0f), dc(0.0f), dc(-par[PAR_GRAVITY])}};
  // preintegration.py::bias_corrected_deltas
  const Vec3 dba = vsub(a.ba, vconst(s.pre_ba + 3 * i));
  const Vec3 dbg = vsub(a.bg, vconst(s.pre_bg + 3 * i));
  const Vec3 cp = vadd(vadd(vconst(s.pre_p + 3 * i), mv(jac, 0, 9, dba)), mv(jac, 0, 12, dbg));
  const Vec3 cv = vadd(vadd(vconst(s.pre_v + 3 * i), mv(jac, 6, 9, dba)), mv(jac, 6, 12, dbg));
  const Quat cq = qnormalize(qmul(qconst(s.pre_q + 4 * i), qexp(mv(jac, 3, 12, dbg))));
  Dual x[9];
  Vec3 dp;
  for (int c = 0; c < 3; ++c)
    dp.x[c] = b.p.x[c] - a.p.x[c] - a.v.x[c] * dc(dt) - (0.5f * g.x[c]) * dc(dt) * dc(dt);
  const Vec3 rp = vsub(qinvrotate(a.q, dp), cp);
  Quat dq = qmul(qconj(cq), qmul(qconj(a.q), b.q));
  if (dq.x[0].v < 0.0f) dq = {{-dq.x[0], -dq.x[1], -dq.x[2], -dq.x[3]}};
  Vec3 dv;
  for (int c = 0; c < 3; ++c) dv.x[c] = b.v.x[c] - a.v.x[c] - g.x[c] * dc(dt);
  const Vec3 rv = vsub(qinvrotate(a.q, dv), cv);
  for (int c = 0; c < 3; ++c) {
    x[c] = rp.x[c];
    x[3 + c] = 2.0f * dq.x[1 + c];
    x[6 + c] = rv.x[c];
  }
  const float* info = s.sqrt_info + 81 * i;
  for (int r = 0; r < 9; ++r) {
    Dual acc = dc(info[9 * r]) * x[0];
    for (int c = 1; c < 9; ++c) acc = acc + dc(info[9 * r + c]) * x[c];
    out[r] = acc;
  }
  const float sdt = sqrtf(fmaxf(dt, 1e-3f));
  for (int c = 0; c < 3; ++c) {
    out[9 + c] = (b.ba.x[c] - a.ba.x[c]) / (sdt * par[PAR_ACC_BIAS_NOISE]);
    out[12 + c] = (b.bg.x[c] - a.bg.x[c]) / (sdt * par[PAR_GYR_BIAS_NOISE]);
  }
}

// `_prior_residual`: prior_sqrt_info @ (p, log, v, ba, bg) of key 0, 15 rows.
__device__ void prior_rows(const Smem& s, const Key& k0, Dual* out) {
  Dual raw[kKeyDim];
  const Vec3 rot = qlog(qmul(qconj(qconst(s.prior_q)), k0.q));
  for (int c = 0; c < 3; ++c) {
    raw[c] = k0.p.x[c] - dc(s.prior_p[c]);
    raw[3 + c] = rot.x[c];
    raw[6 + c] = k0.v.x[c] - dc(s.prior_v[c]);
    raw[9 + c] = k0.ba.x[c] - dc(s.prior_ba[c]);
    raw[12 + c] = k0.bg.x[c] - dc(s.prior_bg[c]);
  }
  for (int r = 0; r < kKeyDim; ++r) {
    Dual acc = dc(s.prior_info[15 * r]) * raw[0];
    for (int c = 1; c < kKeyDim; ++c) acc = acc + dc(s.prior_info[15 * r + c]) * raw[c];
    out[r] = acc;
  }
}

// `_pose_prior_residuals` (6 rows) and `_gravity_residuals` (3) of key k.
__device__ void key_rows(const Smem& s, const float* par, int k, const Key& key, Dual* out) {
  const bool drift = s.drift[k] != 0.0f;
  const float sig_t = drift ? par[PAR_POSE_T_DRIFT] : par[PAR_POSE_T];
  const float sig_r = drift ? par[PAR_POSE_R_DRIFT] : par[PAR_POSE_R];
  const Vec3 rr = qlog(qmul(qconj(qconst(s.obs_q + 4 * k)), key.q));
  const bool obs = s.obs_valid[k] != 0.0f;
  for (int c = 0; c < 3; ++c) {
    out[c] = obs ? (key.p.x[c] - dc(s.obs_t[3 * k + c])) / sig_t : dc(0.0f);
    out[3 + c] = obs ? rr.x[c] / sig_r : dc(0.0f);
  }
  const Vec3 down = {{dc(0.0f), dc(0.0f), dc(-1.0f)}};
  const Vec3 err = vcross(qrotate(qremove_yaw(key.q), down), vconst(s.grav_dir + 3 * k));
  const bool grav = s.grav_valid[k] != 0.0f;
  for (int c = 0; c < 3; ++c) out[6 + c] = grav ? err.x[c] / par[PAR_GRAVITY_NOISE] : dc(0.0f);
}

// ----- the phases of one iteration -----

// One work item of the Jacobian: column c = 15 k + j and one of its parts
// (0: key k's prior or IMU factor, 1: the IMU factor of key k + 1, 2: key
// k's pose and gravity rows), part-major so that a warp's threads take one
// path. Writes its rows of J^T (column-masked), and the residuals where
// j == 0. The rows it writes are the same every iteration; the rest of
// J^T stays zero.
__device__ void jacobian_item(const Smem& s, const float* par, int w, int num_keys, int item) {
  const int n = kKeyDim * w;
  const int c = item % n, part = item / n;
  const int k = c / kKeyDim, j = c % kKeyDim;
  const float col_mask = k < num_keys ? 1.0f : 0.0f;
  float* jt = s.jt + c * ld_j(w);
  Dual rows[kKeyDim];
  int row0, count;
  bool live;
  if (part == 0) {
    row0 = kRowsPerKey * k;
    count = kKeyDim;
    live = true;  // the prior has no mask; IMU factor k's is key k's
    if (k == 0) {
      prior_rows(s, key_at(s, 0, j), rows);
    } else {
      live = k < num_keys;
      if (live) imu_rows(s, par, k, key_at(s, k - 1, -1), key_at(s, k, j), rows);
    }
  } else if (part == 1) {
    if (k + 1 >= w) return;
    row0 = kRowsPerKey * (k + 1);
    count = kKeyDim;
    live = k + 1 < num_keys;
    if (live) imu_rows(s, par, k + 1, key_at(s, k, j), key_at(s, k + 1, -1), rows);
  } else {
    row0 = kRowsPerKey * k + kKeyDim;
    count = kRowsPerKey - kKeyDim;
    live = k < num_keys;
    if (live) key_rows(s, par, k, key_at(s, k, j), rows);
  }
#pragma unroll
  for (int r = 0; r < kKeyDim; ++r) {
    if (r >= count) break;
    const Dual x = live ? rows[r] : dc(0.0f);
    jt[row0 + r] = x.t * col_mask;
    if (j == 0 && part != 1) s.r[row0 + r] = x.v;
  }
}

// A 4 x 4 tile (ta, tb), ta >= tb, of J^T J, over the rows the two column
// groups share (rows outside hold exact zeros in one or the other).
__device__ void normal_tile(const Smem& s, int w, int ta, int tb) {
  const int n = kKeyDim * w, lj = ld_j(w), lh = ld_h(w);
  const int a0 = 4 * ta, b0 = 4 * tb;
  const int ka_lo = a0 / kKeyDim, ka_hi = min(a0 + 3, n - 1) / kKeyDim;
  const int kb_lo = b0 / kKeyDim, kb_hi = min(b0 + 3, n - 1) / kKeyDim;
  const int r_lo = kRowsPerKey * max(ka_lo, kb_lo);
  const int r_hi = min(kRowsPerKey * w, kRowsPerKey * (min(ka_hi, kb_hi) + 2));
  float acc[4][4] = {};
  const float* ja[4];
  const float* jb[4];
  for (int i = 0; i < 4; ++i) {
    ja[i] = s.jt + min(a0 + i, n - 1) * lj;
    jb[i] = s.jt + min(b0 + i, n - 1) * lj;
  }
  for (int r = r_lo; r < r_hi; ++r) {
    float va[4], vb[4];
    for (int i = 0; i < 4; ++i) {
      va[i] = ja[i][r];
      vb[i] = jb[i][r];
    }
    for (int i = 0; i < 4; ++i)
      for (int l = 0; l < 4; ++l) acc[i][l] = fmaf(va[i], vb[l], acc[i][l]);
  }
  for (int i = 0; i < 4; ++i)
    for (int l = 0; l < 4; ++l) {
      const int a = a0 + i, b = b0 + l;
      if (a < n && b <= a) s.h[a * lh + b] = acc[i][l];
    }
}

// g[a] = (J^T r)[a], over the rows of column a's key and the next.
__device__ void gradient_entry(const Smem& s, int w, int a) {
  const int k = a / kKeyDim;
  const float* ja = s.jt + a * ld_j(w);
  const int r_hi = min(kRowsPerKey * w, kRowsPerKey * (k + 2));
  float acc = 0.0f;
  for (int r = kRowsPerKey * k; r < r_hi; ++r) acc = fmaf(ja[r], s.r[r], acc);
  s.g[a] = acc;
}

// First column of H's band in row i: the previous key's first.
__device__ __forceinline__ int band_lo(int i) { return kKeyDim * max(0, i / kKeyDim - 1); }

// H's lower band is block tridiagonal in 15 x 15 blocks: D_b on the
// diagonal (key b with itself), E_b below it (key b + 1 with key b). Its
// Cholesky factor keeps that shape, and one warp computes it a block at a
// time in registers, a column a step with the column's values passed by
// shuffles: lane i < 15 holds row i of D_b, lane 15 + i row i of E_b and
// row i of D_{b+1}, which takes E_b's part of the trailing update as the
// columns of block b go by (the same right-looking updates, A_ij -=
// (A_ik / A_kk) A_jk, as a dense factorization of the band).
__device__ __forceinline__ float shfl(float v, int lane) { return __shfl_sync(0xffffffffu, v, lane); }

__device__ void block_cholesky_solve(const Smem& s, int w, int lane) {
  const int lh = ld_h(w);
  const int i15 = lane < kKeyDim ? lane : lane - kKeyDim;  // the lane's row within its block
  float r[kKeyDim], dn[kKeyDim];
  // block 0's D rows
#pragma unroll
  for (int j = 0; j < kKeyDim; ++j) r[j] = lane < kKeyDim && j <= lane ? s.h[lane * lh + j] : 0.0f;
  for (int b = 0; b < w; ++b) {
    const int c0 = kKeyDim * b;  // block b's first column
    const bool next = b + 1 < w;
    const bool e_row = lane >= kKeyDim && lane < 2 * kKeyDim && next;
    const int er = c0 + kKeyDim + i15;  // the E / D_{b+1} row of lanes 15..29
#pragma unroll
    for (int j = 0; j < kKeyDim; ++j) {
      if (lane >= kKeyDim) r[j] = e_row ? s.h[er * lh + c0 + j] : 0.0f;
      dn[j] = e_row && j <= i15 ? s.h[er * lh + c0 + kKeyDim + j] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kKeyDim; ++k) {
      const float lk = r[k] / shfl(r[k], k);  // A_ik / A_kk
#pragma unroll
      for (int j = k + 1; j < kKeyDim; ++j) {
        const float ajk = shfl(r[k], j);
        if ((lane < kKeyDim && lane >= j) || e_row) r[j] = fmaf(-lk, ajk, r[j]);
      }
#pragma unroll
      for (int j = 0; j < kKeyDim; ++j) {
        const float ajk = shfl(r[k], kKeyDim + j);
        if (e_row && j <= i15) dn[j] = fmaf(-lk, ajk, dn[j]);
      }
    }
    // L = A_ik / sqrt(A_kk) into the band; x keeps 1 / L_kk
    float inv_l = 0.0f;
#pragma unroll
    for (int k = 0; k < kKeyDim; ++k) {
      const float il = 1.0f / sqrtf(shfl(r[k], k));
      if (lane == k) inv_l = il;
      if (lane < kKeyDim && lane > k) s.h[(c0 + lane) * lh + c0 + k] = r[k] * il;
      if (e_row) s.h[er * lh + c0 + k] = r[k] * il;
    }
    if (lane < kKeyDim) s.x[c0 + lane] = inv_l;
    // D_{b+1}, Schur-updated, to lanes 0..14
#pragma unroll
    for (int j = 0; j < kKeyDim; ++j) {
      const float v = shfl(dn[j], (lane + kKeyDim) & 31);
      if (lane < kKeyDim) r[j] = v;
    }
  }
  __syncwarp();
  // L y = g / d, a block at a time: y_b -= E_{b-1} y_{b-1}, then down D_b
  float prev = 0.0f;
  for (int b = 0; b < w; ++b) {
    const int c0 = kKeyDim * b;
    const int row = c0 + i15;
    float y = lane < kKeyDim ? s.g[row] * s.inv[row] : 0.0f;
    if (b > 0) {
#pragma unroll
      for (int k = 0; k < kKeyDim; ++k) {
        const float yk = shfl(prev, k);
        if (lane < kKeyDim) y = fmaf(-s.h[row * lh + c0 - kKeyDim + k], yk, y);
      }
    }
#pragma unroll
    for (int k = 0; k < kKeyDim; ++k) {
      const float yk = shfl(y, k) * s.x[c0 + k];
      if (lane == k) y = yk;
      else if (lane > k && lane < kKeyDim) y = fmaf(-s.h[row * lh + c0 + k], yk, y);
    }
    prev = y;
    if (lane < kKeyDim) s.g[row] = y;
  }
  // L^T x = y, a block at a time from the last: x_b -= E_b^T x_{b+1}, then up D_b^T
  for (int b = w - 1; b >= 0; --b) {
    const int c0 = kKeyDim * b;
    const int col = c0 + i15;
    float x = lane < kKeyDim ? s.g[col] : 0.0f;
    if (b + 1 < w) {
#pragma unroll
      for (int k = 0; k < kKeyDim; ++k) {
        const float xk = shfl(prev, k);
        if (lane < kKeyDim) x = fmaf(-s.h[(c0 + kKeyDim + k) * lh + col], xk, x);
      }
    }
#pragma unroll
    for (int k = kKeyDim - 1; k >= 0; --k) {
      const float xk = shfl(x, k) * s.x[c0 + k];
      if (lane == k) x = xk;
      else if (lane < k) x = fmaf(-s.h[(c0 + k) * lh + col], xk, x);
    }
    prev = x;
    if (lane < kKeyDim) s.y[col] = x;
  }
}

// Key k's update by the guarded delta: `_states_apply_delta`.
__device__ void apply_delta(const Smem& s, int k) {
  Vec3 dr;
  const float* dk = s.x + kKeyDim * k;  // the guarded delta
  for (int c = 0; c < 3; ++c) dr.x[c] = dc(dk[3 + c]);
  const Quat q = qnormalize(qmul(qexp(dr), qconst(s.q + 4 * k)));
  for (int c = 0; c < 4; ++c) s.q[4 * k + c] = q.x[c].v;
  for (int c = 0; c < 3; ++c) {
    s.p[3 * k + c] += dk[c];
    s.v[3 * k + c] += dk[6 + c];
    s.ba[3 * k + c] += dk[9 + c];
    s.bg[3 * k + c] += dk[12 + c];
  }
}

__device__ __forceinline__ float in_f(const Args& a, int field, int64_t at) {
  return static_cast<const float*>(a.in[field])[at];
}
__device__ __forceinline__ float in_b(const Args& a, int field, int64_t at) {
  return static_cast<const unsigned char*>(a.in[field])[at] ? 1.0f : 0.0f;
}

__global__ void __launch_bounds__(kThreads, 1)
    window_gn_kernel(const Args args, int w, int iterations) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(smem, w);
  const int tid = threadIdx.x;
  const int lane = blockIdx.x;
  const int n = kKeyDim * w, rows = kRowsPerKey * w, lj = ld_j(w), lh = ld_h(w);
  const float* par = args.par;
  const int num_keys = static_cast<const int*>(args.in[IN_NUM_KEYS])[lane];

  // ----- load the lane's window -----
  const int64_t kw = (int64_t)lane * w;
  for (int e = tid; e < 4 * w; e += kThreads) {
    s.q[e] = in_f(args, IN_Q, 4 * kw + e);
    s.obs_q[e] = in_f(args, IN_OBS_Q, 4 * kw + e);
    s.pre_q[e] = in_f(args, IN_PRE_Q, 4 * kw + e);
  }
  for (int e = tid; e < 3 * w; e += kThreads) {
    s.p[e] = in_f(args, IN_P, 3 * kw + e);
    s.v[e] = in_f(args, IN_V, 3 * kw + e);
    s.ba[e] = in_f(args, IN_BA, 3 * kw + e);
    s.bg[e] = in_f(args, IN_BG, 3 * kw + e);
    s.obs_t[e] = in_f(args, IN_OBS_T, 3 * kw + e);
    s.pre_p[e] = in_f(args, IN_PRE_P, 3 * kw + e);
    s.pre_v[e] = in_f(args, IN_PRE_V, 3 * kw + e);
    s.pre_ba[e] = in_f(args, IN_PRE_BA, 3 * kw + e);
    s.pre_bg[e] = in_f(args, IN_PRE_BG, 3 * kw + e);
    s.grav_dir[e] = in_f(args, IN_GRAV_DIR, 3 * kw + e);
  }
  for (int e = tid; e < w; e += kThreads) {
    s.dt[e] = in_f(args, IN_PRE_DT, kw + e);
    s.drift[e] = in_b(args, IN_OBS_DRIFT, kw + e);
    s.obs_valid[e] = in_b(args, IN_OBS_VALID, kw + e);
    s.grav_valid[e] = in_b(args, IN_GRAV_VALID, kw + e);
  }
  for (int e = tid; e < 54 * w; e += kThreads) {  // pre_jac[k][0:9, 9:15]
    const int k = e / 54, r = (e % 54) / 6, c = e % 6;
    s.jac[e] = in_f(args, IN_PRE_JAC, (kw + k) * 225 + r * 15 + 9 + c);
  }
  for (int e = tid; e < 81 * w; e += kThreads) s.sqrt_info[e] = in_f(args, IN_PRE_SQRT_INFO, 81 * kw + e);
  for (int e = tid; e < 225; e += kThreads) s.prior_info[e] = in_f(args, IN_PRIOR_SQRT_INFO, 225 * (int64_t)lane + e);
  for (int e = tid; e < 4; e += kThreads) s.prior_q[e] = in_f(args, IN_PRIOR_Q, 4 * (int64_t)lane + e);
  for (int e = tid; e < 3; e += kThreads) {
    s.prior_p[e] = in_f(args, IN_PRIOR_P, 3 * (int64_t)lane + e);
    s.prior_v[e] = in_f(args, IN_PRIOR_V, 3 * (int64_t)lane + e);
    s.prior_ba[e] = in_f(args, IN_PRIOR_BA, 3 * (int64_t)lane + e);
    s.prior_bg[e] = in_f(args, IN_PRIOR_BG, 3 * (int64_t)lane + e);
  }
  __syncthreads();

  for (int e = tid; e < n * lj; e += kThreads) s.jt[e] = 0.0f;
  __syncthreads();

  const int tiles = (n + 3) / 4;
  const int tile_pairs = tiles * (tiles + 1) / 2;
  for (int it = 0; it < iterations; ++it) {
    // 1-3. residuals and the column-masked Jacobian (J^T, rows key by key)
    for (int item = tid; item < 3 * n; item += kThreads) jacobian_item(s, par, w, num_keys, item);
    __syncthreads();
    // 4. J^T J (its lower band) and J^T r
    for (int t = tid; t < tile_pairs + n; t += kThreads) {
      if (t >= tile_pairs) {
        gradient_entry(s, w, t - tile_pairs);
        continue;
      }
      int ta = (int)((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);  // row of the triangle
      while (ta * (ta + 1) / 2 > t) --ta;
      while ((ta + 1) * (ta + 2) / 2 <= t) ++ta;
      const int tb = t - ta * (ta + 1) / 2;
      if ((4 * ta) / kKeyDim - min(4 * tb + 3, n - 1) / kKeyDim <= 1) normal_tile(s, w, ta, tb);
    }
    __syncthreads();
    // 5. Jacobi scaling: d = sqrt(clamp(diag, 1e-12)), H / d_i / d_j + 1e-5 I
    for (int a = tid; a < n; a += kThreads) {
      const float h = s.h[a * lh + a];
      s.inv[a] = 1.0f / sqrtf(h < kEps ? kEps : h);
    }
    __syncthreads();
    for (int e = tid; e < n * 2 * kKeyDim; e += kThreads) {
      const int i = e / (2 * kKeyDim), j = band_lo(i) + e % (2 * kKeyDim);
      if (j > i) continue;
      float* hij = s.h + i * lh + j;
      *hij = *hij * s.inv[i] * s.inv[j] + (i == j ? 1e-5f : 0.0f);
    }
    __syncthreads();
    // 6. Cholesky and the two triangular solves, in warp 0
    if (tid < 32) block_cholesky_solve(s, w, tid);
    __syncthreads();
    // 7. delta = -x / d under the guards: active mask, isfinite, clamp
    for (int a = tid; a < n; a += kThreads) {
      float delta = -s.y[a] * s.inv[a];
      if (a / kKeyDim >= num_keys) delta = 0.0f;
      if (!isfinite(delta)) delta = 0.0f;
      s.x[a] = fminf(fmaxf(delta, -1.0f), 1.0f);
    }
    __syncthreads();
    // 8. the retraction, a key a thread
    for (int k = tid; k < w; k += kThreads) apply_delta(s, k);
    __syncthreads();
  }

  for (int e = tid; e < 4 * w; e += kThreads) args.out[OUT_Q][4 * kw + e] = s.q[e];
  for (int e = tid; e < 3 * w; e += kThreads) {
    args.out[OUT_P][3 * kw + e] = s.p[e];
    args.out[OUT_V][3 * kw + e] = s.v[e];
    args.out[OUT_BA][3 * kw + e] = s.ba[e];
    args.out[OUT_BG][3 * kw + e] = s.bg[e];
  }
}

}  // namespace

// inputs: NUM_INPUTS device pointers in WindowState's field order, each
// with a leading lane axis of `batch`; outputs: q, p, v, ba, bg (batch, w,
// 4|3) float32; params: NUM_PARAMS floats (Param). Returns a CUDA error,
// or -1 where a window of w keys takes more shared memory than a block
// may have on the current device.
extern "C" int dliom_window_gn(const void* const* inputs, void* const* outputs, const float* params,
                               int batch, int w, int iterations, void* stream) {
  if (batch <= 0) return 0;
  Args args;
  for (int i = 0; i < NUM_INPUTS; ++i) args.in[i] = inputs[i];
  for (int i = 0; i < NUM_OUTPUTS; ++i) args.out[i] = static_cast<float*>(outputs[i]);
  for (int i = 0; i < NUM_PARAMS; ++i) args.par[i] = params[i];
  const size_t bytes = smem_floats(w) * sizeof(float);
  // The shared-memory attribute belongs to the current device's context:
  // raise it on every device the kernel launches on, to the largest size
  // asked there so far.
  constexpr int kMaxDevices = 64;
  static size_t configured[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (bytes > configured[device]) {
    int limit = 0;
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (bytes > static_cast<size_t>(limit)) return -1;
    err = cudaFuncSetAttribute(window_gn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = bytes;
  }
  window_gn_kernel<<<batch, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(args, w, iterations);
  return static_cast<int>(cudaGetLastError());
}
