// Joystick task step around the physics launch, for ONE env: `tk_pre_env`
// computes everything the physics launch needs, `tk_post_env` everything
// after it. The standing task (envs/standing.py) inherits the step and
// differs in its reward terms alone: its build (-DTK_STANDING=1) computes
// its six terms in place of the joystick's ten.
//
// Replaces no TPU kernel: the JAX package's step (envs/joystick.py) is
// plain jnp that XLA fuses into a few kernels. The port's eager
// `Joystick.step` (envs/joystick.py) launches ~240 small PyTorch kernels
// around the physics launch, each a few kB; this body is that step's
// elementwise work, in its order and formulas, as two launches. What bounds
// it on an H100: neither bytes (under 3 KB in and out per env and control
// step, ~0.1 us at 3.35 TB/s for 128 envs) nor operations, but one thread's
// chain of dependent loads and transcendental calls: one thread per env, no
// shared memory, no barrier.
//
// Arithmetic: each PyTorch operation of the eager step rounds once, so
// products are not fused into sums here (the card's build takes
// -fmad=false, the host harness -ffp-contract=off) and every operation of
// the eager step keeps its order. What may still differ in the last bits:
// sums over a row (PyTorch's reduction trees order them otherwise), the
// vector norms, and on the host the transcendental functions (PyTorch's
// CPU kernels take SLEEF's). A tensor divided by a Python number is, as in
// PyTorch's CUDA kernel, a product with its reciprocal on the card and a
// division on the host (`tk_divs`).
//
// Shapes are compile-time constants (-D flags from envs/task_kernel.py),
// one build per robot, observation layout and term set; the env's index
// tables, scales and flags are one TkRecord, which a launch passes by
// pointer; the record points at the gait oracle's frame table. The body is __host__
// __device__, so the same text compiles with a host C++ compiler
// (task_step_host.cpp, a test harness that loops over the envs).
#pragma once

#include <float.h>
#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define TK_HD __host__ __device__
#else
#define TK_HD
#endif

#if !defined(TK_NQ) || !defined(TK_NV) || !defined(TK_NU) || !defined(TK_NSITE) ||     \
    !defined(TK_NSENS) || !defined(TK_NFOOT) || !defined(TK_KPTS) || !defined(TK_AHIST) || \
    !defined(TK_IHIST) || !defined(TK_IMITATION) || !defined(TK_OBS_MOTOR) ||           \
    !defined(TK_OBS_PHASE) || !defined(TK_GDX) || !defined(TK_GDY) || !defined(TK_GDT) || \
    !defined(TK_GPH) || !defined(TK_GDIM)
#error "task dimensions must be given with -D flags (envs/task_kernel.py)"
#endif

// The term set: the joystick's (TK_STANDING 0, the default: the joystick
// builds take no flag for it) or the standing task's (1).
#ifndef TK_STANDING
#define TK_STANDING 0
#endif

#if TK_NU != 14 && TK_NU != 10
#error "the robot has 14 actuators (legs 0:5 and 9:14, head 5:9) or 10 (legs only)"
#endif

#define TK_HEAD (TK_NU == 14)
#define TK_NLEG 10
#define TK_NCMD 7
#define TK_NCON (TK_NFOOT * TK_KPTS)
#define TK_NREF (TK_IMITATION ? TK_GDIM : 0)  // the reference frame in info and obs
#define TK_NFOOTVEL (3 * TK_NFOOT)
#define TK_SIZE(n) ((n) > 0 ? (n) : 1)  // a register array of n entries, n >= 0
// the observation `state`: gyro, accelerometer, command, joint angles, joint
// velocities, three past actions, [motor targets], contacts, then the gait
// phase or the reference frame
#define TK_NSTATE (3 + 3 + TK_NCMD + 5 * TK_NU + TK_OBS_MOTOR * TK_NU + TK_NFOOT + \
                   (TK_OBS_PHASE ? 2 : TK_NREF))
// `privileged_state`: state, gyro, accelerometer, gravity, local and global
// velocities, joint angles and velocities, base height, actuator forces,
// contacts, feet velocities, air times, the reference frame, [the gait's
// frame index and phase]
#define TK_NPRIV (TK_NSTATE + 15 + 3 * TK_NU + 1 + TK_NFOOT + TK_NFOOTVEL + TK_NFOOT + TK_NREF + \
                  (TK_OBS_PHASE ? 3 : 0))

#if TK_STANDING
// The reward terms, in the order of Standing._get_reward.
#define TK_NTERM 6
#define TK_ORIENT 0
#define TK_TORQUES 1
#define TK_ACTION_RATE 2
#define TK_ALIVE 3
#define TK_STAND_STILL 4
#define TK_HEAD_POS 5
#else
// The reward terms, in the order of Joystick._get_reward.
#define TK_NTERM 10
#define TK_TRACK_LIN 0
#define TK_TRACK_ANG 1
#define TK_TORQUES 2
#define TK_ACTION_RATE 3
#define TK_ALIVE 4
#define TK_IMIT 5
#define TK_STAND_STILL 6
#define TK_PROGRESS 7
#define TK_YAW_L1 8
#define TK_LIN_L1 9
#endif

// A command resamples once the step counter passes this (Joystick.step).
#define TK_RESAMPLE_AFTER 500
#define TK_PI 3.14159265358979323846  // math.pi

// The env's tables and constants (envs/task_kernel.py:record_fields keeps
// the same fields in the same order).
struct TkRecord {
  const float* gait;                  // (GDX, GDY, GDT, GPH, GDIM) frames, or null
  float gait_x[TK_GDX];               // the command grid
  float gait_y[TK_GDY];
  float gait_t[TK_GDT];
  float default_act[TK_NU];           // home ctrl
  float qpos_noise[TK_NU];            // joint-angle noise scale per actuator
  float ref_offset[TK_NLEG];          // gait retarget (zeros where there is none)
  float reward_scale[TK_NTERM];
  float down[3];                      // the world's down
  float dt;                           // control step
  float action_scale;
  float motor_lim;                    // max motor velocity x dt
  float dof_vel_scale;
  float level;                        // noise level
  float sc_gyro, sc_accel, sc_gravity, sc_jvel;
  float sigma;                        // tracking sigma
  int act_qadr[TK_NU];                // actuated joints' qpos and qvel addresses
  int act_dadr[TK_NU];
  int backlash_qadr[TK_NU];           // qpos address of each actuator's backlash joint, or -1
  int metric_row[TK_NTERM];           // row of each term's metric, or -1 where its scale is 0
  int foot_vel[TK_NFOOTVEL];          // sensordata addresses of the feet's velocities
  int feet_site[TK_NFOOT];
  int imu_site;
  int fb_qadr, fb_dadr;               // floating base
  int s_gyro, s_accel, s_up, s_linvel, s_angvel;  // sensordata addresses of 3-vectors
  int row_swing, row_lin, row_ang, row_head;      // metric rows (row_head -1 without a head)
  int speed_limit;                    // clamp the motor targets' slew
  int head_direct;                    // the head servos take the head command
  int push_enable;
#if TK_STANDING
  int head_ungated;                   // head_pos without its gate on moving commands
#endif
};

// Pointers of the launch before the physics: inputs, then outputs.
struct TkPre {
  const float* action;           // (B, nu)
  const float* qvel;             // (B, nv)
  const int32_t* imitation_i;    // (B,)
  const float* command;          // (B, 7)
  const float* hist;             // (B, AHIST * nu) action history
  const int32_t* push_step;      // (B,)
  const int32_t* push_interval;  // (B,)
  const float* prev_targets;     // (B, nu)
  const int64_t* delay;          // (B,) action delay draws
  const float* push_theta;       // (B,)
  const float* push_mag;         // (B,)
  int32_t* o_imitation_i;        // (B,)
  float* o_phase;                // (B, 2), null unless IMITATION and OBS_PHASE
  float* o_ref;                  // (B, NREF), null unless IMITATION
  float* o_hist;                 // (B, AHIST * nu)
  float* o_push;                 // (B, 2)
  float* o_qvel;                 // (B, nv)
  float* o_targets;              // (B, nu)
  int batch;
  const TkRecord* rec;
};

// Pointers of the launch after the physics: inputs, then outputs.
struct TkPost {
  const float* qpos;             // (B, nq) after the physics
  const float* qvel;             // (B, nv)
  const float* site_xpos;        // (B, nsite, 3)
  const float* site_xmat;        // (B, nsite, 3, 3)
  const float* force;            // (B, nu) actuator forces
  const float* contact_dist;     // (B, NFOOT * KPTS)
  const float* sens;             // (B, nsensordata)
  const float* action;           // (B, nu)
  const float* command;          // (B, 7) this step's command
  const float* last_act;         // (B, nu)
  const float* last_last_act;
  const float* last3_act;
  const float* targets;          // (B, nu) this step's motor targets
  const int32_t* imitation_i;    // (B,) this step's
  const float* phase;            // (B, 2) this step's, read where OBS_PHASE
  const float* ref;              // (B, NREF) this step's
  const float* air_time;         // (B, NFOOT)
  const float* swing_peak;       // (B, NFOOT)
  const int32_t* step;           // (B,)
  const int32_t* push_step;      // (B,)
  const float* imu_hist;         // (B, 3 * IHIST)
  const float* n_gyro;           // (B, 3) unit noises
  const float* n_accel;
  const float* n_gravity;
  const float* n_jpos;           // (B, nu)
  const float* n_jvel;
  const float* new_command;      // (B, 7) taken where the command resamples
  float* o_state;                // (B, NSTATE)
  float* o_priv;                 // (B, NPRIV)
  float* o_reward;               // (B,)
  float* o_done;                 // (B,)
  float* o_air_time;             // (B, NFOOT)
  float* o_swing_peak;           // (B, NFOOT)
  uint8_t* o_contact;            // (B, NFOOT) bool
  float* o_imu_hist;             // (B, 3 * IHIST)
  int32_t* o_step;               // (B,)
  int32_t* o_push_step;          // (B,)
  float* o_command;              // (B, 7)
  float* o_metrics;              // (nmetrics, B)
  int batch;
  const TkRecord* rec;
};

TK_HD inline TkPre tk_pre_args(const TkRecord* rec, const void* const* p, int batch) {
  TkPre a;
  a.action = (const float*)p[0];
  a.qvel = (const float*)p[1];
  a.imitation_i = (const int32_t*)p[2];
  a.command = (const float*)p[3];
  a.hist = (const float*)p[4];
  a.push_step = (const int32_t*)p[5];
  a.push_interval = (const int32_t*)p[6];
  a.prev_targets = (const float*)p[7];
  a.delay = (const int64_t*)p[8];
  a.push_theta = (const float*)p[9];
  a.push_mag = (const float*)p[10];
  a.o_imitation_i = (int32_t*)p[11];
  a.o_phase = (float*)p[12];
  a.o_ref = (float*)p[13];
  a.o_hist = (float*)p[14];
  a.o_push = (float*)p[15];
  a.o_qvel = (float*)p[16];
  a.o_targets = (float*)p[17];
  a.batch = batch;
  a.rec = rec;
  return a;
}

TK_HD inline TkPost tk_post_args(const TkRecord* rec, const void* const* p, int batch) {
  TkPost a;
  a.qpos = (const float*)p[0];
  a.qvel = (const float*)p[1];
  a.site_xpos = (const float*)p[2];
  a.site_xmat = (const float*)p[3];
  a.force = (const float*)p[4];
  a.contact_dist = (const float*)p[5];
  a.sens = (const float*)p[6];
  a.action = (const float*)p[7];
  a.command = (const float*)p[8];
  a.last_act = (const float*)p[9];
  a.last_last_act = (const float*)p[10];
  a.last3_act = (const float*)p[11];
  a.targets = (const float*)p[12];
  a.imitation_i = (const int32_t*)p[13];
  a.phase = (const float*)p[14];
  a.ref = (const float*)p[15];
  a.air_time = (const float*)p[16];
  a.swing_peak = (const float*)p[17];
  a.step = (const int32_t*)p[18];
  a.push_step = (const int32_t*)p[19];
  a.imu_hist = (const float*)p[20];
  a.n_gyro = (const float*)p[21];
  a.n_accel = (const float*)p[22];
  a.n_gravity = (const float*)p[23];
  a.n_jpos = (const float*)p[24];
  a.n_jvel = (const float*)p[25];
  a.new_command = (const float*)p[26];
  a.o_state = (float*)p[27];
  a.o_priv = (float*)p[28];
  a.o_reward = (float*)p[29];
  a.o_done = (float*)p[30];
  a.o_air_time = (float*)p[31];
  a.o_swing_peak = (float*)p[32];
  a.o_contact = (uint8_t*)p[33];
  a.o_imu_hist = (float*)p[34];
  a.o_step = (int32_t*)p[35];
  a.o_push_step = (int32_t*)p[36];
  a.o_command = (float*)p[37];
  a.o_metrics = (float*)p[38];
  a.batch = batch;
  a.rec = rec;
  return a;
}

// ------------------------------------------------------------ PyTorch's ops
TK_HD inline bool tk_isnan(float x) { return x != x; }

TK_HD inline float tk_sq(float x) { return x * x; }  // torch.square

// A tensor divided by a Python number: PyTorch's CUDA kernel multiplies by
// the reciprocal, its CPU kernel divides.
TK_HD inline float tk_divs(float a, float b) {
#ifdef __CUDA_ARCH__
  return a * (1.0f / b);
#else
  return a / b;
#endif
}

// torch.nan_to_num
TK_HD inline float tk_nn(float x) {
  if (tk_isnan(x)) return 0.0f;
  if (x > FLT_MAX) return FLT_MAX;
  if (x < -FLT_MAX) return -FLT_MAX;
  return x;
}

// torch.clamp(x, min=lo) and torch.clamp(x, lo, hi) with Python numbers: NaN stays
TK_HD inline float tk_clamp_min(float x, float lo) { return tk_isnan(x) ? x : (x < lo ? lo : x); }

TK_HD inline float tk_clamp(float x, float lo, float hi) {
  if (tk_isnan(x)) return x;
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// torch.clamp(x, lo, hi) with tensor bounds: a NaN in x, then in a bound, wins
TK_HD inline float tk_clamp_t(float x, float lo, float hi) {
  if (tk_isnan(x)) return x;
  if (tk_isnan(lo)) return lo;
  if (tk_isnan(hi)) return hi;
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// torch.maximum and torch.minimum: NaN wins
TK_HD inline float tk_maximum(float a, float b) {
  if (tk_isnan(a) || tk_isnan(b)) return a + b;
  return a > b ? a : b;
}

TK_HD inline float tk_minimum(float a, float b) {
  if (tk_isnan(a) || tk_isnan(b)) return a + b;
  return a < b ? a : b;
}

// torch.linalg.vector_norm of 2 and 3 entries
TK_HD inline float tk_norm2(float a, float b) { return sqrtf(fmaf(b, b, a * a)); }

TK_HD inline float tk_norm3(float a, float b, float c) { return sqrtf(fmaf(c, c, fmaf(b, b, a * a))); }

// torch.remainder of integers: the sign of the divisor (0 where it is 0,
// which no draw gives)
TK_HD inline int tk_mod(int a, int b) {
  if (b == 0) return 0;
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// GaitOracle._nearest: the grid point nearest to x clamped to the grid,
// torch.argmin's first minimum on ties; a NaN x gives 0, as argmin's first NaN
template <int N>
TK_HD inline int tk_nearest(const float (&grid)[N], float x) {
  if (tk_isnan(x)) return 0;
  x = tk_clamp_t(x, grid[0], grid[N - 1]);
  int best = 0;
  float bd = fabsf(grid[0] - x);
#pragma unroll
  for (int k = 1; k < N; k++) {
    float d = fabsf(grid[k] - x);
    if (d < bd) {
      bd = d;
      best = k;
    }
  }
  return best;
}

// The k-th leg joint among the robot's actuators ([:5] + [9:] of 14), and
// in a 16-joint gait frame ([:5] + [11:]).
TK_HD inline int tk_leg(int k) { return (TK_HEAD && k >= 5) ? k + 4 : k; }

TK_HD inline int tk_leg16(int k) { return k >= 5 ? k + 6 : k; }

// Each body reads everything it needs before its first store: the compiler
// has to assume that a store may alias a later load, and such a load would
// leave only after the store, one trip to memory after another. Registers
// hold what is read (index tables are read from memory, never as indices
// into a register array, which would put the array in local memory).

// ------------------------------------------------------- before the physics
TK_HD inline void tk_pre_env(const TkRecord& R, const TkPre& a, int e) {
  float cmd[TK_NCMD], act[TK_NU], prev[TK_NU], hist[TK_SIZE((TK_AHIST - 1) * TK_NU)], qv[TK_NV];
#pragma unroll
  for (int k = 0; k < TK_NCMD; k++) cmd[k] = a.command[e * TK_NCMD + k];
#pragma unroll
  for (int k = 0; k < TK_NU; k++) {
    act[k] = a.action[e * TK_NU + k];
    prev[k] = a.prev_targets[e * TK_NU + k];
  }
#pragma unroll
  for (int k = 0; k < (TK_AHIST - 1) * TK_NU; k++) hist[k] = a.hist[e * TK_AHIST * TK_NU + k];
#pragma unroll
  for (int k = 0; k < TK_NV; k++) qv[k] = a.qvel[e * TK_NV + k];
  const int64_t dl = a.delay[e];
  const int push_step = a.push_step[e], interval = a.push_interval[e];
  const float th = a.push_theta[e], mag = a.push_mag[e];
  const int fb = R.fb_dadr;

  // the gait's frame index and reference frame
#if TK_IMITATION
  const int i = tk_mod(a.imitation_i[e] + 1, TK_GPH);
  const int ix = tk_nearest(R.gait_x, cmd[0]);
  const int iy = tk_nearest(R.gait_y, cmd[1]);
  const int it = tk_nearest(R.gait_t, cmd[2]);
  const float* frame_p = R.gait + ((((ix * TK_GDY + iy) * TK_GDT + it) * TK_GPH) + i) * TK_GDIM;
  float frame[TK_GDIM];
#pragma unroll
  for (int d = 0; d < TK_GDIM; d++) frame[d] = frame_p[d];
#endif

  // the motor targets from the delayed action: slot `slot` of the history
  // with this step's action first (the draws lie in [0, AHIST),
  // StepDraws.sample; kept there, a bad one reads no other env's row)
  const int slot = dl < 0 ? 0 : (dl >= TK_AHIST ? TK_AHIST - 1 : (int)dl);
  float targets[TK_NU];
#pragma unroll
  for (int k = 0; k < TK_NU; k++) {
    float delayed = act[k];
#pragma unroll
    for (int s = 1; s < TK_AHIST; s++)
      if (slot == s) delayed = hist[(s - 1) * TK_NU + k];
    float t = R.default_act[k] + delayed * R.action_scale;
    if (R.speed_limit) t = tk_clamp_t(t, prev[k] - R.motor_lim, prev[k] + R.motor_lim);
    targets[k] = t;
  }
#if TK_HEAD
  if (R.head_direct) {
#pragma unroll
    for (int k = 0; k < 4; k++) targets[5 + k] = cmd[3 + k];
  }
#endif

  // the push: due every push_interval steps, added to the base velocity
  const float due = tk_mod(push_step + 1, interval) == 0 ? 1.0f : 0.0f;
  const float on = R.push_enable ? 1.0f : 0.0f;
  const float px = cosf(th) * due * on, py = sinf(th) * due * on;

  // the stores
#if TK_IMITATION
  a.o_imitation_i[e] = i;
#if TK_OBS_PHASE
  const float ph = tk_divs((float)i, (float)TK_GPH) * 2.0f * (float)TK_PI;
  a.o_phase[e * 2 + 0] = cosf(ph);
  a.o_phase[e * 2 + 1] = sinf(ph);
#endif
#pragma unroll
  for (int d = 0; d < TK_GDIM; d++) a.o_ref[e * TK_NREF + d] = frame[d];
#else
  a.o_imitation_i[e] = 0;
#endif
  float* ohist = a.o_hist + e * TK_AHIST * TK_NU;
#pragma unroll
  for (int k = 0; k < TK_NU; k++) ohist[k] = act[k];
#pragma unroll
  for (int k = 0; k < (TK_AHIST - 1) * TK_NU; k++) ohist[TK_NU + k] = hist[k];
  a.o_push[e * 2 + 0] = px;
  a.o_push[e * 2 + 1] = py;
#pragma unroll
  for (int k = 0; k < TK_NV; k++) {
    float v = qv[k];
    if (k == fb) v = qv[k] + px * mag;
    if (k == fb + 1) v = qv[k] + py * mag;
    a.o_qvel[e * TK_NV + k] = v;
  }
#pragma unroll
  for (int k = 0; k < TK_NU; k++) a.o_targets[e * TK_NU + k] = targets[k];
}

// -------------------------------------------------------- after the physics
TK_HD inline void tk_post_env(const TkRecord& R, const TkPost& a, int e) {
  const int B = a.batch;
  const float* q = a.qpos + e * TK_NQ;
  const float* qv = a.qvel + e * TK_NV;
  const float* sens = a.sens + e * TK_NSENS;
  const float lvl = R.level;

  // the physics state: termination on a NaN, the joints, the base
  bool nan = false;
#pragma unroll
  for (int k = 0; k < TK_NQ; k++) nan = nan || tk_isnan(q[k]);
#pragma unroll
  for (int k = 0; k < TK_NV; k++) nan = nan || tk_isnan(qv[k]);
  float jq[TK_NU], jang[TK_NU], jv[TK_NU], def[TK_NU], force[TK_NU];
#pragma unroll
  for (int k = 0; k < TK_NU; k++) {
    jq[k] = q[R.act_qadr[k]];
    const int b = R.backlash_qadr[k];
    jang[k] = b >= 0 ? jq[k] + q[b] : jq[k];
    jv[k] = qv[R.act_dadr[k]];
    def[k] = R.default_act[k];
    force[k] = a.force[e * TK_NU + k];
  }
  const float height = q[R.fb_qadr + 2];

  // feet: contacts, air time (grown before the reward), swing peak
  bool contact[TK_NFOOT];
  float air[TK_NFOOT], peak[TK_NFOOT];
#pragma unroll
  for (int f = 0; f < TK_NFOOT; f++) {
    bool c = false;
#pragma unroll
    for (int k = 0; k < TK_KPTS; k++) c = c || a.contact_dist[e * TK_NCON + f * TK_KPTS + k] < 0.0f;
    contact[f] = c;
    air[f] = a.air_time[e * TK_NFOOT + f] + R.dt;
    const float z = a.site_xpos[(e * TK_NSITE + R.feet_site[f]) * 3 + 2];
    peak[f] = tk_maximum(a.swing_peak[e * TK_NFOOT + f], z);
  }

  // sensors; the gravity in the IMU's frame, site_xmat^T @ down
  float gyro[3], accel[3], linvel[3], angvel[3], gravity[3], footv[TK_NFOOTVEL];
  const float* xmat = a.site_xmat + (e * TK_NSITE + R.imu_site) * 9;
#pragma unroll
  for (int k = 0; k < 3; k++) {
    gyro[k] = sens[R.s_gyro + k];
    accel[k] = sens[R.s_accel + k];
    linvel[k] = sens[R.s_linvel + k];
    angvel[k] = sens[R.s_angvel + k];
    gravity[k] = fmaf(xmat[6 + k], R.down[2], fmaf(xmat[3 + k], R.down[1], xmat[k] * R.down[0]));
  }
  const float up_z = sens[R.s_up + 2];
#if TK_STANDING
  const float up_x = sens[R.s_up], up_y = sens[R.s_up + 1];
#endif
#pragma unroll
  for (int k = 0; k < TK_NFOOTVEL; k++) footv[k] = sens[R.foot_vel[k]];

  // the info and the draws
  float cmd[TK_NCMD], new_cmd[TK_NCMD], act[TK_NU], last[TK_NU], last2[TK_NU], last3[TK_NU], tgt[TK_NU];
#pragma unroll
  for (int k = 0; k < TK_NCMD; k++) {
    cmd[k] = a.command[e * TK_NCMD + k];
    new_cmd[k] = a.new_command[e * TK_NCMD + k];
  }
#pragma unroll
  for (int k = 0; k < TK_NU; k++) {
    act[k] = a.action[e * TK_NU + k];
    last[k] = a.last_act[e * TK_NU + k];
    last2[k] = a.last_last_act[e * TK_NU + k];
    last3[k] = a.last3_act[e * TK_NU + k];
    tgt[k] = a.targets[e * TK_NU + k];
  }
  float ref[TK_SIZE(TK_NREF)];
#pragma unroll
  for (int k = 0; k < TK_NREF; k++) ref[k] = a.ref[e * TK_NREF + k];
  const int frame_i = a.imitation_i[e];
#if TK_OBS_PHASE
  const float phase[2] = {a.phase[e * 2 + 0], a.phase[e * 2 + 1]};
#endif
  const int step = a.step[e] + 1;
  const int push_step = a.push_step[e] + 1;
  float imu[TK_SIZE(3 * (TK_IHIST - 1))];
#pragma unroll
  for (int k = 0; k < 3 * (TK_IHIST - 1); k++) imu[k] = a.imu_hist[e * 3 * TK_IHIST + k];
  float n_gyro[3], n_accel[3], n_grav[3], n_jpos[TK_NU], n_jvel[TK_NU];
#pragma unroll
  for (int k = 0; k < 3; k++) {
    n_gyro[k] = a.n_gyro[e * 3 + k];
    n_accel[k] = a.n_accel[e * 3 + k];
    n_grav[k] = a.n_gravity[e * 3 + k];
  }
#pragma unroll
  for (int k = 0; k < TK_NU; k++) {
    n_jpos[k] = a.n_jpos[e * TK_NU + k];
    n_jvel[k] = a.n_jvel[e * TK_NU + k];
  }
  int metric_row[TK_NTERM];
#pragma unroll
  for (int t = 0; t < TK_NTERM; t++) metric_row[t] = R.metric_row[t];
  const int row_swing = R.row_swing, row_lin = R.row_lin, row_ang = R.row_ang;
#if TK_HEAD
  const int row_head = R.row_head;
#endif
#if TK_STANDING && TK_HEAD
  const bool head_ungated = R.head_ungated != 0;
#endif

  // the noisy readings of the observation
  float noisy_gyro[3], noisy_accel[3], noisy_grav[3], obs_jpos[TK_NU], obs_jvel[TK_NU];
#pragma unroll
  for (int k = 0; k < 3; k++) {
    noisy_gyro[k] = gyro[k] + n_gyro[k] * lvl * R.sc_gyro;
    noisy_accel[k] = accel[k] + n_accel[k] * lvl * R.sc_accel;
    noisy_grav[k] = gravity[k] + n_grav[k] * lvl * R.sc_gravity;
  }
#pragma unroll
  for (int k = 0; k < TK_NU; k++) {
    obs_jpos[k] = (jang[k] + n_jpos[k] * lvl * R.qpos_noise[k]) - def[k];
    obs_jvel[k] = (jv[k] + n_jvel[k] * lvl * R.sc_jvel) * R.dof_vel_scale;
  }

  // termination: upside down, or a NaN in the state
  const bool done = up_z < 0.0f || nan;

  // the reward terms (envs/rewards.py, envs/imitation.py)
  float r[TK_NTERM];
#if TK_STANDING
  r[TK_ORIENT] = tk_nn(tk_sq(up_x) + tk_sq(up_y));
#else
  {
    const float ex = tk_sq(cmd[0] - linvel[0]);
    const float ey = tk_clamp_min(fabsf(linvel[1] - cmd[1]) - 0.1f, 0.0f);
    r[TK_TRACK_LIN] = tk_nn(expf(tk_divs(-(ex + tk_sq(ey)), R.sigma)));
  }
  r[TK_TRACK_ANG] = tk_nn(expf(tk_divs(-tk_sq(cmd[2] - gyro[2]), R.sigma)));
#endif
  {
    float s = 0.0f, u = 0.0f;
#pragma unroll
    for (int k = 0; k < TK_NU; k++) s = s + tk_sq(force[k]);
#pragma unroll
    for (int k = 0; k < TK_NU; k++) u = u + tk_sq(act[k] - last[k]);
    r[TK_TORQUES] = tk_nn(s);
    r[TK_ACTION_RATE] = tk_nn(u);
  }
  r[TK_ALIVE] = 1.0f;
  const float cn3 = tk_norm3(cmd[0], cmd[1], cmd[2]);
#if TK_STANDING
  {  // stand_still over the legs alone (ignore_head)
    float pose = 0.0f, vel = 0.0f;
#pragma unroll
    for (int k = 0; k < TK_NLEG; k++) pose = pose + fabsf(jq[tk_leg(k)] - def[tk_leg(k)]);
#pragma unroll
    for (int k = 0; k < TK_NLEG; k++) vel = vel + fabsf(jv[tk_leg(k)]);
    r[TK_STAND_STILL] = tk_nn(pose + vel) * (cn3 < 0.01f ? 1.0f : 0.0f);
  }
#if TK_HEAD
  {  // head_pos, gated to moving commands unless ungated
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; k++) s = s + tk_sq(jq[5 + k] - cmd[3 + k]);
    const float err = tk_nn(s);
    r[TK_HEAD_POS] = head_ungated ? err : err * (cn3 > 0.01f ? 1.0f : 0.0f);
  }
#else
  r[TK_HEAD_POS] = 0.0f;  // nothing to track on the no-head robot
#endif
#else
#if TK_IMITATION
  {
    float bq[6];  // the base velocity
#pragma unroll
    for (int k = 0; k < 6; k++) bq[k] = qv[R.fb_dadr + k];
    float s = tk_sq(bq[0] - ref[34]) + tk_sq(bq[1] - ref[35]);
    float im = 1.0f * expf(s * -8.0f);
    im = im + 1.0f * expf(tk_sq(bq[2] - ref[36]) * -8.0f);
    s = tk_sq(bq[3] - ref[37]) + tk_sq(bq[4] - ref[38]);
    im = im + 0.5f * expf(s * -2.0f);
    im = im + 0.5f * expf(tk_sq(bq[5] - ref[39]) * -2.0f);
    s = 0.0f;
#pragma unroll
    for (int k = 0; k < TK_NLEG; k++) s = s + tk_sq(jq[tk_leg(k)] - (ref[tk_leg16(k)] + R.ref_offset[k]));
    im = im - 15.0f * s;
    s = 0.0f;
#pragma unroll
    for (int k = 0; k < TK_NLEG; k++) s = s + tk_sq(jv[tk_leg(k)] - ref[16 + tk_leg16(k)]);
    im = im - 1.0e-3f * s;
    float m = 0.0f;
#pragma unroll
    for (int f = 0; f < TK_NFOOT; f++) m = m + (contact[f] == (ref[32 + f] > 0.5f) ? 1.0f : 0.0f);
    im = im + 1.0f * m;
    im = im * (cn3 > 0.01f ? 1.0f : 0.0f);
    r[TK_IMIT] = tk_nn(im);
  }
#else
  r[TK_IMIT] = 0.0f;
#endif
  {
    float pose = 0.0f, vel = 0.0f;
#pragma unroll
    for (int k = 0; k < TK_NU; k++) pose = pose + fabsf(jq[k] - def[k]);
#pragma unroll
    for (int k = 0; k < TK_NU; k++) vel = vel + fabsf(jv[k]);
    r[TK_STAND_STILL] = tk_nn(pose + vel) * (cn3 < 0.01f ? 1.0f : 0.0f);
  }
  {
    const float cn = tk_norm2(cmd[0], cmd[1]);
    const float along = (linvel[0] * cmd[0] + linvel[1] * cmd[1]) / tk_clamp_min(cn, 1e-6f);
    const float frac = tk_minimum(tk_clamp_min(along, 0.0f), cn) / tk_clamp_min(cn, 1e-6f);
    r[TK_PROGRESS] = tk_nn(frac * (cn > 0.01f ? 1.0f : 0.0f));
  }
  r[TK_YAW_L1] = tk_nn(fabsf(cmd[2] - gyro[2]));
  r[TK_LIN_L1] = tk_nn(fabsf(cmd[0] - linvel[0]) + fabsf(cmd[1] - linvel[1]));
#endif
  float total = 0.0f;
#pragma unroll
  for (int t = 0; t < TK_NTERM; t++) total = total + r[t] * R.reward_scale[t];
  float metric[TK_NTERM];
#pragma unroll
  for (int t = 0; t < TK_NTERM; t++) metric[t] = R.reward_scale[t] > 0.0f ? r[t] : -r[t];  // a cost negated

  // the info: the command's resample, the feet's reset on contact
  const bool resample = step > TK_RESAMPLE_AFTER;
  float keep[TK_NFOOT], sp = 0.0f;
#pragma unroll
  for (int f = 0; f < TK_NFOOT; f++) {
    keep[f] = contact[f] ? 0.0f : 1.0f;
    sp = sp + peak[f] * keep[f];
  }

  // the stores: the observations `state` and `privileged_state`
  float* st = a.o_state + e * TK_NSTATE;
  float* pv = a.o_priv + e * TK_NPRIV;
  int o = 0;
  auto put = [&](float v) {  // an entry of `state`, which opens `privileged_state`
    st[o] = v;
    pv[o] = v;
    o++;
  };
#pragma unroll
  for (int k = 0; k < 3; k++) put(noisy_gyro[k]);
#pragma unroll
  for (int k = 0; k < 3; k++) put(noisy_accel[k]);
#pragma unroll
  for (int k = 0; k < TK_NCMD; k++) put(cmd[k]);
#pragma unroll
  for (int k = 0; k < TK_NU; k++) put(obs_jpos[k]);
#pragma unroll
  for (int k = 0; k < TK_NU; k++) put(obs_jvel[k]);
#pragma unroll
  for (int k = 0; k < TK_NU; k++) put(last[k]);
#pragma unroll
  for (int k = 0; k < TK_NU; k++) put(last2[k]);
#pragma unroll
  for (int k = 0; k < TK_NU; k++) put(last3[k]);
#if TK_OBS_MOTOR
#pragma unroll
  for (int k = 0; k < TK_NU; k++) put(tgt[k]);
#endif
#pragma unroll
  for (int f = 0; f < TK_NFOOT; f++) put(contact[f] ? 1.0f : 0.0f);
#if TK_OBS_PHASE
  put(phase[0]);
  put(phase[1]);
#else
#pragma unroll
  for (int k = 0; k < TK_NREF; k++) put(ref[k]);
#endif
#pragma unroll
  for (int k = 0; k < 3; k++) pv[o++] = gyro[k];
#pragma unroll
  for (int k = 0; k < 3; k++) pv[o++] = accel[k];
#pragma unroll
  for (int k = 0; k < 3; k++) pv[o++] = gravity[k];
#pragma unroll
  for (int k = 0; k < 3; k++) pv[o++] = linvel[k];
#pragma unroll
  for (int k = 0; k < 3; k++) pv[o++] = angvel[k];
#pragma unroll
  for (int k = 0; k < TK_NU; k++) pv[o++] = jang[k] - def[k];
#pragma unroll
  for (int k = 0; k < TK_NU; k++) pv[o++] = jv[k];
  pv[o++] = height;
#pragma unroll
  for (int k = 0; k < TK_NU; k++) pv[o++] = force[k];
#pragma unroll
  for (int f = 0; f < TK_NFOOT; f++) pv[o++] = contact[f] ? 1.0f : 0.0f;
#pragma unroll
  for (int k = 0; k < TK_NFOOTVEL; k++) pv[o++] = footv[k];
#pragma unroll
  for (int f = 0; f < TK_NFOOT; f++) pv[o++] = air[f];
#pragma unroll
  for (int k = 0; k < TK_NREF; k++) pv[o++] = ref[k];
#if TK_OBS_PHASE
  pv[o++] = (float)frame_i;
  pv[o++] = phase[0];
  pv[o++] = phase[1];
#endif

  // the reward, termination and info
  a.o_reward[e] = tk_clamp(total * R.dt, 0.0f, 10000.0f);
  a.o_done[e] = done ? 1.0f : 0.0f;
  a.o_step[e] = (done || resample) ? 0 : step;
  a.o_push_step[e] = push_step;
#pragma unroll
  for (int k = 0; k < TK_NCMD; k++) a.o_command[e * TK_NCMD + k] = resample ? new_cmd[k] : cmd[k];
#pragma unroll
  for (int f = 0; f < TK_NFOOT; f++) {
    a.o_air_time[e * TK_NFOOT + f] = air[f] * keep[f];
    a.o_swing_peak[e * TK_NFOOT + f] = peak[f] * keep[f];
    a.o_contact[e * TK_NFOOT + f] = contact[f] ? 1 : 0;
  }
  // the IMU history: the noisy gravity first (the observation reads none of it)
  float* oimu = a.o_imu_hist + e * 3 * TK_IHIST;
#pragma unroll
  for (int k = 0; k < 3; k++) oimu[k] = noisy_grav[k];
#pragma unroll
  for (int k = 0; k < 3 * (TK_IHIST - 1); k++) oimu[3 + k] = imu[k];

  // the metrics: each term with a scale, the swing peak, the tracking
  // errors of this step's command
  float* met = a.o_metrics;
#pragma unroll
  for (int t = 0; t < TK_NTERM; t++)
    if (metric_row[t] >= 0) met[metric_row[t] * B + e] = metric[t];
  met[row_swing * B + e] = sp * (1.0f / TK_NFOOT);
  met[row_lin * B + e] = tk_norm2(cmd[0] - linvel[0], cmd[1] - linvel[1]);
  met[row_ang * B + e] = fabsf(cmd[2] - gyro[2]);
#if TK_HEAD
  if (row_head >= 0) {
    float h = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; k++) h = h + fabsf(jq[5 + k] - cmd[3 + k]);
    met[row_head * B + e] = h * 0.25f;
  }
#endif
}
