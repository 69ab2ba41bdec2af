// Physics megakernel body: every substep of one control step for ONE env.
//
// Replaces the Pallas TPU kernel of
// open_duck_playground_tpu/physics/megakernel.py:megakernel_step_batched
// (kernel body _build_kernel.<locals>.kernel, flat-plane path) with one env
// per CUDA thread. The math is the dense form of the torch engine in
// physics/*.py (its plain version is forward.step_reference):
//   FK -> CoM/cdof -> composite-inertia mass matrix -> velocities -> RNE
//   bias -> passive + servo forces -> dense Cholesky -> hull-vs-floor
//   contacts (4 deepest vertices per foot) -> constraint rows (dof
//   friction, joint limits, pyramid facets) -> Newton (1 iteration,
//   5-step analytic linesearch) -> sensors (last substep) -> semi-implicit
//   Euler.
// The floor is a plane, or with -DMK_HFIELD=1 a heightfield (the IS_HFIELD
// branch of the TPU kernel): the height and the triangle normal under each
// hull vertex are read straight from the height table in device memory, so
// every contact has its own normal and tangent frame. The TPU kernel's
// per-foot patches, tile table and one-hot contractions stand in for a
// per-lane gather that a CUDA thread simply does.
// State stays in thread-local storage across the substeps; device memory is
// read once and written once per control step.
//
// Model dimensions are compile-time constants (-D flags from the model's
// spec), so every per-thread array has a fixed size. The structure tables
// live in one MkModel in __constant__ memory; the 8 domain-randomized fields
// come per env. The functions are __host__ __device__ so that the same body
// also compiles with a host C++ compiler (megakernel_host.cpp, a test
// harness only).
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define MK_HD __host__ __device__
#else
#define MK_HD
#endif

#if !defined(MK_NQ) || !defined(MK_NV) || !defined(MK_NU) || !defined(MK_NBODY) ||   \
    !defined(MK_NJNT) || !defined(MK_NSITE) || !defined(MK_NSENSDATA) ||               \
    !defined(MK_NSENSOR) || !defined(MK_NFOOT) || !defined(MK_NVERT) ||                \
    !defined(MK_KPTS) || !defined(MK_NFRIC) || !defined(MK_NLIM)
#error "model dimensions must be given with -D flags (physics/megakernel.py)"
#endif

#ifndef MK_HFIELD
#define MK_HFIELD 0
#endif

#if MK_NV > 32 || MK_NVERT > 32
#error "dof and hull-vertex sets are 32-bit masks: nv and hull_nvert must be <= 32"
#endif

#define MK_NCON (MK_NFOOT * MK_KPTS)
#define MK_NTRI (MK_NV * (MK_NV + 1) / 2)
#define MK_TRI(i, j) ((i) * ((i) + 1) / 2 + (j))  // packed lower triangle, i >= j

#define MK_FREE 0
#define MK_HINGE 3

// Sensor kinds, in the order of physics/megakernel.py:SENSOR_KINDS.
#define MK_GYRO 0
#define MK_VELOCIMETER 1
#define MK_ACCELEROMETER 2
#define MK_FRAMEZAXIS 3
#define MK_FRAMEXAXIS 4
#define MK_FRAMELINVEL 5
#define MK_FRAMEANGVEL 6
#define MK_FRAMEPOS 7
#define MK_FRAMEQUAT 8

#define MK_MINVAL 1e-15f
#define MK_MINIMP 0.0001f
#define MK_MAXIMP 0.9999f

// Structure tables. Only 4-byte fields, so the layout has no padding; the
// ctypes mirror in physics/megakernel.py:_model_struct lists the same fields
// in the same order, and mk_model_size() lets the wrapper check the size.
struct MkModel {
  int body_parent[MK_NBODY];
  int body_jntadr[MK_NBODY];
  int body_jntnum[MK_NBODY];
  float body_intree[MK_NBODY];          // 1 if any dof moves the body
  unsigned int body_dofs[MK_NBODY];     // bit d: dof d moves the body
  float body_pos[MK_NBODY][3];
  float body_quat[MK_NBODY][4];
  float body_iquat[MK_NBODY][4];
  float body_inertia[MK_NBODY][3];
  int jnt_type[MK_NJNT];
  int jnt_qposadr[MK_NJNT];
  int jnt_dofadr[MK_NJNT];
  int jnt_bodyid[MK_NJNT];
  float jnt_pos[MK_NJNT][3];
  float jnt_axis[MK_NJNT][3];
  int dof_body[MK_NV];
  unsigned int dof_pred[MK_NV];         // bit e: dof e carries dof d's frame
  float dof_ftm[MK_NV];                 // 0 on free-joint translations
  float dof_damping[MK_NV];
  int act_qadr[MK_NU];
  int act_dadr[MK_NU];
  float act_ctrlrange[MK_NU][2];
  float act_forcerange[MK_NU][2];
  int site_body[MK_NSITE];
  float site_pos[MK_NSITE][3];
  float site_quat[MK_NSITE][4];
  int sensor_kind[MK_NSENSOR];
  int sensor_obj[MK_NSENSOR];
  int sensor_adr[MK_NSENSOR];
  int foot_body[MK_NFOOT];
  float foot_gpos[MK_NFOOT][3];
  float foot_gquat[MK_NFOOT][4];
  float foot_hull[MK_NFOOT][MK_NVERT][3];
  float foot_invw[MK_NFOOT];            // body_invweight0 of foot + floor
  int floor_body;
  float floor_gpos[3];
  float floor_gquat[4];
  float con_k;                          // contact stiffness, damping and
  float con_b;                          // solimp (floor params win)
  float con_solimp[5];
  int fric_dof[MK_NFRIC];
  float fric_b[MK_NFRIC];
  float fric_R[MK_NFRIC];
  int lim_qadr[MK_NLIM];
  int lim_dadr[MK_NLIM];
  float lim_range[MK_NLIM][2];
  float lim_margin[MK_NLIM];
  float lim_k[MK_NLIM];
  float lim_b[MK_NLIM];
  float lim_solimp[MK_NLIM][5];
  float lim_invw[MK_NLIM];
  float gravity[3];
  float timestep;
  int iterations;
  int ls_iterations;
#if MK_HFIELD
  int hf_nrow;                          // heightfield grid, rows along y
  int hf_ncol;
  float hf_sx;                          // half extents in x and y
  float hf_sy;
  float hf_dx;                          // cell size: 2 sx / (ncol - 1)
  float hf_dy;
#endif
};

// Per-env tensors, row-major with the env axis first. Inputs: the state,
// ctrl and the 8 randomized fields as the TPU wrapper lays them out
// (qpos0, gainprm[:,0], biasprm[:,0:3], frictionloss, armature, body_mass,
// body_ipos, floor friction). Outputs: the Data fields of the step.
struct MkArgs {
  const float* qpos;      // (B, nq)
  const float* qvel;      // (B, nv)
  const float* ctrl;      // (B, nu)
  const float* warm;      // (B, nv) qacc_warmstart
  const float* qpos0;     // (B, nq)
  const float* gain0;     // (B, nu)
  const float* bias0;     // (B, nu)
  const float* bias1;     // (B, nu)
  const float* bias2;     // (B, nu)
  const float* frictionloss;  // (B, nv)
  const float* armature;  // (B, nv)
  const float* mass;      // (B, nbody)
  const float* ipos;      // (B, nbody, 3)
  const float* mu;        // (B,) floor sliding friction
#if MK_HFIELD
  const float* hfield;    // (nrow, ncol) heights in the floor geom's frame, shared by all envs
#endif
  float* o_qpos;          // (B, nq)
  float* o_qvel;          // (B, nv)
  float* o_qacc;          // (B, nv)
  float* o_warm;          // (B, nv)
  float* o_site_xpos;     // (B, nsite, 3)
  float* o_site_xmat;     // (B, nsite, 3, 3)
  float* o_actuator_force;  // (B, nu)
  float* o_contact_dist;  // (B, ncon)
  float* o_sensordata;    // (B, nsensordata)
  int batch;
  int n_substeps;
};

// Pointers of one launch, in MkArgs order: 14 inputs, the height table
// where there is one, 9 outputs.
#define MK_NPTR (23 + MK_HFIELD)

MK_HD inline MkArgs mk_args(const void* const* p, int batch, int n_substeps) {
  MkArgs a;
  a.qpos = (const float*)p[0];
  a.qvel = (const float*)p[1];
  a.ctrl = (const float*)p[2];
  a.warm = (const float*)p[3];
  a.qpos0 = (const float*)p[4];
  a.gain0 = (const float*)p[5];
  a.bias0 = (const float*)p[6];
  a.bias1 = (const float*)p[7];
  a.bias2 = (const float*)p[8];
  a.frictionloss = (const float*)p[9];
  a.armature = (const float*)p[10];
  a.mass = (const float*)p[11];
  a.ipos = (const float*)p[12];
  a.mu = (const float*)p[13];
#if MK_HFIELD
  a.hfield = (const float*)p[14];
#endif
  const void* const* o = p + 14 + MK_HFIELD;
  a.o_qpos = (float*)o[0];
  a.o_qvel = (float*)o[1];
  a.o_qacc = (float*)o[2];
  a.o_warm = (float*)o[3];
  a.o_site_xpos = (float*)o[4];
  a.o_site_xmat = (float*)o[5];
  a.o_actuator_force = (float*)o[6];
  a.o_contact_dist = (float*)o[7];
  a.o_sensordata = (float*)o[8];
  a.batch = batch;
  a.n_substeps = n_substeps;
  return a;
}

// ------------------------------------------------------------------ helpers
// max/min/clamp that keep a NaN in x, as torch.clamp / jnp.maximum do, so
// a blown-up env stays visibly non-finite for the NaN quarantine.
MK_HD inline float mk_max(float x, float lo) { return (x != x || x > lo) ? x : lo; }
MK_HD inline float mk_min(float x, float hi) { return (x != x || x < hi) ? x : hi; }
MK_HD inline float mk_clamp(float x, float lo, float hi) { return mk_min(mk_max(x, lo), hi); }

MK_HD inline float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

MK_HD inline void cross3(const float* a, const float* b, float* o) {
  float x = a[1] * b[2] - a[2] * b[1];
  float y = a[2] * b[0] - a[0] * b[2];
  float z = a[0] * b[1] - a[1] * b[0];
  o[0] = x;
  o[1] = y;
  o[2] = z;
}

MK_HD inline void quat_mul(const float* a, const float* b, float* o) {
  float w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  float x = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  float y = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  float z = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
  o[0] = w;
  o[1] = x;
  o[2] = y;
  o[3] = z;
}

// o = R(q) v
MK_HD inline void quat_rot(const float* q, const float* v, float* o) {
  float uv[3], uuv[3];
  cross3(q + 1, v, uv);
  cross3(q + 1, uv, uuv);
  for (int i = 0; i < 3; i++) o[i] = v[i] + 2.0f * (q[0] * uv[i] + uuv[i]);
}

// Row-major 3x3 rotation matrix of a quaternion.
MK_HD inline void quat_mat(const float* q, float* R) {
  float w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = 1 - 2 * (y * y + z * z);
  R[1] = 2 * (x * y - w * z);
  R[2] = 2 * (x * z + w * y);
  R[3] = 2 * (x * y + w * z);
  R[4] = 1 - 2 * (x * x + z * z);
  R[5] = 2 * (y * z - w * x);
  R[6] = 2 * (x * z - w * y);
  R[7] = 2 * (y * z + w * x);
  R[8] = 1 - 2 * (x * x + y * y);
}

MK_HD inline void axis_angle_quat(const float* axis, float angle, float* q) {
  float half = 0.5f * angle;
  float s = sinf(half);
  q[0] = cosf(half);
  q[1] = axis[0] * s;
  q[2] = axis[1] * s;
  q[3] = axis[2] * s;
}

// Spatial inertia about the CoM in compact form: mass m, first moment
// h = m c and the rotational block It = Ic + m (|c|^2 E - c c^T).
// I [w; u] = [It w + h x u; m u - h x w].
struct MkInertia {
  float m;
  float h[3];
  float It[9];
};

MK_HD inline void inertia_apply(const MkInertia& I, const float* v, float* o) {
  float hu[3], hw[3];
  cross3(I.h, v + 3, hu);
  cross3(I.h, v, hw);
  for (int r = 0; r < 3; r++) {
    o[r] = I.It[3 * r] * v[0] + I.It[3 * r + 1] * v[1] + I.It[3 * r + 2] * v[2] + hu[r];
    o[3 + r] = I.m * v[3 + r] - hw[r];
  }
}

// v x m of motion vectors (angular, linear)
MK_HD inline void motion_cross(const float* v, const float* m, float* o) {
  float a[3], b[3], c[3];
  cross3(v, m, a);
  cross3(v, m + 3, b);
  cross3(v + 3, m, c);
  for (int i = 0; i < 3; i++) {
    o[i] = a[i];
    o[3 + i] = b[i] + c[i];
  }
}

// v x* f of a motion and a force vector (torque, force)
MK_HD inline void motion_cross_force(const float* v, const float* f, float* o) {
  float a[3], b[3], c[3];
  cross3(v, f, a);
  cross3(v + 3, f + 3, b);
  cross3(v, f + 3, c);
  for (int i = 0; i < 3; i++) {
    o[i] = a[i] + b[i];
    o[3 + i] = c[i];
  }
}

MK_HD inline float impedance(const float* solimp, float pos) {
  float dmin = solimp[0], dmax = solimp[1], width = solimp[2];
  float mid = solimp[3], power = solimp[4];
  float x = mk_clamp(fabsf(pos) / mk_max(width, MK_MINVAL), 0.0f, 1.0f);
  float a = 1.0f / powf(mid, power - 1);
  float b = 1.0f / powf(1 - mid, power - 1);
  float y = x < mid ? a * powf(x, power) : 1 - b * powf(1 - x, power);
  return mk_clamp(dmin + y * (dmax - dmin), MK_MINIMP, MK_MAXIMP);
}

#if MK_HFIELD
// One height of the table, through the read-only path on the card.
MK_HD inline float hf_at(const float* z, int idx) {
#ifdef __CUDA_ARCH__
  return __ldg(z + idx);
#else
  return z[idx];
#endif
}

// Height and unit normal of the heightfield triangle under (x, y) of the
// floor geom's frame (collision._hfield_height_normal): x spans [-sx, sx]
// over the columns, y spans [-sy, sy] over the rows, each cell splits along
// its (+x, +y) diagonal, and a point outside the grid takes the border cell.
// A NaN coordinate reads cell 0 and gives a NaN height.
MK_HD inline float hfield_height_normal(const MkModel& M, const float* z, float x, float y,
                                        float* n) {
  float fx = mk_clamp((x + M.hf_sx) / M.hf_dx, 0.0f, (float)(M.hf_ncol - 1.001));
  float fy = mk_clamp((y + M.hf_sy) / M.hf_dy, 0.0f, (float)(M.hf_nrow - 1.001));
  float fi = floorf(fx), fj = floorf(fy);
  int i = fx == fx ? (int)fi : 0, j = fy == fy ? (int)fj : 0;
  float u = fx - fi, v = fy - fj;
  float z00 = hf_at(z, j * M.hf_ncol + i), z10 = hf_at(z, j * M.hf_ncol + i + 1);
  float z01 = hf_at(z, (j + 1) * M.hf_ncol + i), z11 = hf_at(z, (j + 1) * M.hf_ncol + i + 1);
  bool lower = u + v <= 1.0f;  // triangle (00, 10, 01), else (11, 10, 01)
  float h = lower ? z00 + u * (z10 - z00) + v * (z01 - z00)
                  : z11 + (1 - u) * (z01 - z11) + (1 - v) * (z10 - z11);
  float nx = lower ? -(z10 - z00) / M.hf_dx : (z01 - z11) / M.hf_dx;
  float ny = lower ? -(z01 - z00) / M.hf_dy : (z10 - z11) / M.hf_dy;
  float nrm = sqrtf(nx * nx + ny * ny + 1.0f);
  n[0] = nx / nrm;
  n[1] = ny / nrm;
  n[2] = 1.0f / nrm;
  return h;
}
#endif

// The normal and tangents of contact c: one frame for all contacts on a
// plane, one per contact on a heightfield.
#if MK_HFIELD
#define MK_CN(c) normal[c]
#define MK_CT1(c) t1[c]
#define MK_CT2(c) t2[c]
#else
#define MK_CN(c) normal
#define MK_CT1(c) t1
#define MK_CT2(c) t2
#endif

// In-place outer-product Cholesky of a packed lower triangle, with the
// engine's pivot floor (linalg.cholesky).
MK_HD inline void chol_packed(float* A) {
  for (int k = 0; k < MK_NV; k++) {
    float piv = sqrtf(mk_max(A[MK_TRI(k, k)], 1e-12f));
    for (int i = k; i < MK_NV; i++) A[MK_TRI(i, k)] = A[MK_TRI(i, k)] / piv;
    for (int i = k + 1; i < MK_NV; i++) {
      float lik = A[MK_TRI(i, k)];
      for (int j = k + 1; j <= i; j++) A[MK_TRI(i, j)] -= lik * A[MK_TRI(j, k)];
    }
  }
}

// x = (L L^T)^{-1} b, in place on x (holds b on entry).
MK_HD inline void chol_solve_packed(const float* L, float* x) {
  for (int k = 0; k < MK_NV; k++) {
    float s = x[k];
    for (int j = 0; j < k; j++) s -= L[MK_TRI(k, j)] * x[j];
    x[k] = s / L[MK_TRI(k, k)];
  }
  for (int k = MK_NV - 1; k >= 0; k--) {
    float s = x[k];
    for (int j = k + 1; j < MK_NV; j++) s -= L[MK_TRI(j, k)] * x[j];
    x[k] = s / L[MK_TRI(k, k)];
  }
}

// y = M x, M symmetric in packed lower form
MK_HD inline void symv_packed(const float* M, const float* x, float* y) {
  for (int i = 0; i < MK_NV; i++) {
    float s = 0.0f;
    for (int j = 0; j <= i; j++) s += M[MK_TRI(i, j)] * x[j];
    for (int j = i + 1; j < MK_NV; j++) s += M[MK_TRI(j, i)] * x[j];
    y[i] = s;
  }
}

// Rows of the constraint problem. Rows [0, NFRIC) are dof friction, the
// next NLIM are joint limits (one-hot J: dof index and sign), the last
// NCON*4 are contact facets with dense J. Inactive rows have D = 0, J = 0
// and aref = 0, so they add nothing to cost, gradient or Hessian: the
// loops skip them.
#define MK_NROW1 (MK_NFRIC + MK_NLIM)
#define MK_NEFC (MK_NROW1 + MK_NCON * 4)

struct MkRows {
  int dof[MK_NROW1];
  float sign[MK_NROW1];
  float J[MK_NCON * 4][MK_NV];
  float aref[MK_NEFC];
  float D[MK_NEFC];
  float R[MK_NEFC];
  float fl[MK_NEFC];
  int active[MK_NEFC];
};

MK_HD inline float row_jx(const MkRows& r, int i, const float* x) {
  if (i < MK_NROW1) return r.sign[i] * x[r.dof[i]];
  const float* J = r.J[i - MK_NROW1];
  float s = 0.0f;
  for (int v = 0; v < MK_NV; v++) s += J[v] * x[v];
  return s;
}

// dc/djar and d2c/djar2 of one row (solver._force_and_hess)
MK_HD inline void row_gh(const MkRows& r, int i, float jar, float* g, float* h) {
  float fl = r.fl[i], D = r.D[i];
  float quad = D * jar;
  if (fl > 0) {
    *g = mk_clamp(quad, -fl, fl);
    *h = fabsf(quad) < fl ? D : 0.0f;
  } else {
    *g = jar < 0 ? quad : 0.0f;
    *h = jar < 0 ? D : 0.0f;
  }
}

MK_HD inline float row_cost(const MkRows& r, int i, float jar) {
  float fl = r.fl[i], D = r.D[i];
  float quad = 0.5f * D * jar * jar;
  if (fl > 0) {
    float lin = fl * fabsf(jar) - 0.5f * fl * fl * r.R[i];
    return fabsf(D * jar) < fl ? quad : lin;
  }
  return jar < 0 ? quad : 0.0f;
}

MK_HD inline float total_cost(const MkRows& r, const float* M, const float* a, const float* x) {
  float dx[MK_NV], Mdx[MK_NV];
  for (int v = 0; v < MK_NV; v++) dx[v] = x[v] - a[v];
  symv_packed(M, dx, Mdx);
  float quad = 0.0f;
  for (int v = 0; v < MK_NV; v++) quad += dx[v] * Mdx[v];
  float c = 0.0f;
  for (int i = 0; i < MK_NEFC; i++) {
    if (!r.active[i]) continue;
    c += row_cost(r, i, row_jx(r, i, x) - r.aref[i]);
  }
  return 0.5f * quad + c;
}

// ------------------------------------------------------------ one env step
MK_HD inline void mk_env_step(const MkModel& M, const MkArgs& a, int e) {
  float qpos[MK_NQ], qvel[MK_NV], ctrl[MK_NU], warm[MK_NV], qpos0[MK_NQ];
  float gain0[MK_NU], bias0[MK_NU], bias1[MK_NU], bias2[MK_NU];
  float fl[MK_NV], arma[MK_NV], mass[MK_NBODY], ipos[MK_NBODY][3];
  for (int i = 0; i < MK_NQ; i++) {
    qpos[i] = a.qpos[(long)e * MK_NQ + i];
    qpos0[i] = a.qpos0[(long)e * MK_NQ + i];
  }
  for (int i = 0; i < MK_NV; i++) {
    qvel[i] = a.qvel[(long)e * MK_NV + i];
    warm[i] = a.warm[(long)e * MK_NV + i];
    fl[i] = a.frictionloss[(long)e * MK_NV + i];
    arma[i] = a.armature[(long)e * MK_NV + i];
  }
  for (int i = 0; i < MK_NU; i++) {
    ctrl[i] = a.ctrl[(long)e * MK_NU + i];
    gain0[i] = a.gain0[(long)e * MK_NU + i];
    bias0[i] = a.bias0[(long)e * MK_NU + i];
    bias1[i] = a.bias1[(long)e * MK_NU + i];
    bias2[i] = a.bias2[(long)e * MK_NU + i];
  }
  for (int b = 0; b < MK_NBODY; b++) {
    mass[b] = a.mass[(long)e * MK_NBODY + b];
    for (int k = 0; k < 3; k++) ipos[b][k] = a.ipos[((long)e * MK_NBODY + b) * 3 + k];
  }
  const float mu = a.mu[e];
  const float dt = M.timestep;

  float xpos[MK_NBODY][3], xquat[MK_NBODY][4];
  float xanchor[MK_NJNT][3], xaxis[MK_NJNT][3];
  float xipos[MK_NBODY][3], ximat[MK_NBODY][9];
  float com[3];
  float cdof[MK_NV][6], cdof_dot[MK_NV][6], cvel[MK_NBODY][6];
  MkInertia ib[MK_NBODY], ic[MK_NBODY];
  float Mq[MK_NTRI], H[MK_NTRI];
  float qfrc[MK_NV], qacc_smooth[MK_NV], qacc[MK_NV];
  float force[MK_NU];
  float con_dist[MK_NCON], con_pos[MK_NCON][3];
#if MK_HFIELD
  float normal[MK_NCON][3], t1[MK_NCON][3], t2[MK_NCON][3];
#else
  float normal[3], t1[3], t2[3];
#endif
  MkRows rows;

  for (int sub = 0; sub < a.n_substeps; sub++) {
    const bool last = sub == a.n_substeps - 1;

    // ---- forward kinematics (parents precede children in MuJoCo order)
    for (int k = 0; k < 3; k++) xpos[0][k] = 0.0f;
    xquat[0][0] = 1.0f;
    xquat[0][1] = xquat[0][2] = xquat[0][3] = 0.0f;
    for (int b = 1; b < MK_NBODY; b++) {
      int p = M.body_parent[b];
      float pos[3], quat[4], t[3];
      quat_rot(xquat[p], M.body_pos[b], t);
      for (int k = 0; k < 3; k++) pos[k] = xpos[p][k] + t[k];
      quat_mul(xquat[p], M.body_quat[b], quat);
      for (int jj = 0; jj < M.body_jntnum[b]; jj++) {
        int j = M.body_jntadr[b] + jj;
        int qa = M.jnt_qposadr[j];
        if (M.jnt_type[j] == MK_FREE) {
          float nrm = sqrtf(qpos[qa + 3] * qpos[qa + 3] + qpos[qa + 4] * qpos[qa + 4] +
                            qpos[qa + 5] * qpos[qa + 5] + qpos[qa + 6] * qpos[qa + 6]);
          for (int k = 0; k < 3; k++) pos[k] = qpos[qa + k];
          for (int k = 0; k < 4; k++) quat[k] = qpos[qa + 3 + k] / nrm;
          for (int k = 0; k < 3; k++) {
            xanchor[j][k] = pos[k];
            xaxis[j][k] = k == 2 ? 1.0f : 0.0f;
          }
        } else {
          float anchor[3], qaa[4], qn[4];
          quat_rot(quat, M.jnt_pos[j], t);
          for (int k = 0; k < 3; k++) anchor[k] = pos[k] + t[k];
          quat_rot(quat, M.jnt_axis[j], xaxis[j]);
          axis_angle_quat(M.jnt_axis[j], qpos[qa] - qpos0[qa], qaa);
          quat_mul(quat, qaa, qn);
          quat_rot(qn, M.jnt_pos[j], t);
          for (int k = 0; k < 3; k++) {
            pos[k] = anchor[k] - t[k];
            xanchor[j][k] = anchor[k];
          }
          for (int k = 0; k < 4; k++) quat[k] = qn[k];
        }
      }
      for (int k = 0; k < 3; k++) xpos[b][k] = pos[k];
      for (int k = 0; k < 4; k++) xquat[b][k] = quat[k];
    }
    for (int b = 0; b < MK_NBODY; b++) {
      float t[3], qi[4];
      quat_rot(xquat[b], ipos[b], t);
      for (int k = 0; k < 3; k++) xipos[b][k] = xpos[b][k] + t[k];
      quat_mul(xquat[b], M.body_iquat[b], qi);
      quat_mat(qi, ximat[b]);
    }

    // ---- subtree CoM and cdof
    {
      float wsum = 0.0f, acc[3] = {0.0f, 0.0f, 0.0f};
      for (int b = 0; b < MK_NBODY; b++) {
        float w = mass[b] * M.body_intree[b];
        wsum += w;
        for (int k = 0; k < 3; k++) acc[k] += w * xipos[b][k];
      }
      for (int k = 0; k < 3; k++) com[k] = acc[k] / wsum;
    }
    for (int j = 0; j < MK_NJNT; j++) {
      int d = M.jnt_dofadr[j];
      float r[3];
      for (int k = 0; k < 3; k++) r[k] = com[k] - xanchor[j][k];
      if (M.jnt_type[j] == MK_FREE) {
        float R[9];
        quat_mat(xquat[M.jnt_bodyid[j]], R);
        for (int i = 0; i < 3; i++) {
          for (int k = 0; k < 6; k++) cdof[d + i][k] = (k == 3 + i) ? 1.0f : 0.0f;
          float ax[3] = {R[i], R[3 + i], R[6 + i]};
          for (int k = 0; k < 3; k++) cdof[d + 3 + i][k] = ax[k];
          cross3(ax, r, &cdof[d + 3 + i][3]);
        }
      } else {
        for (int k = 0; k < 3; k++) cdof[d][k] = xaxis[j][k];
        cross3(xaxis[j], r, &cdof[d][3]);
      }
    }

    // ---- body inertias about the CoM, composite inertias, mass matrix
    for (int b = 0; b < MK_NBODY; b++) {
      float c[3], R[9];
      for (int k = 0; k < 3; k++) c[k] = xipos[b][k] - com[k];
      for (int k = 0; k < 9; k++) R[k] = ximat[b][k];
      float m = mass[b], cc = dot3(c, c);
      ib[b].m = m;
      for (int k = 0; k < 3; k++) ib[b].h[k] = m * c[k];
      for (int r = 0; r < 3; r++)
        for (int s = 0; s < 3; s++) {
          float v = 0.0f;
          for (int k = 0; k < 3; k++) v += R[3 * r + k] * (M.body_inertia[b][k] * R[3 * s + k]);
          ib[b].It[3 * r + s] = v + m * ((r == s ? cc : 0.0f) - c[r] * c[s]);
        }
      ic[b] = ib[b];
    }
    for (int b = MK_NBODY - 1; b > 0; b--) {
      int p = M.body_parent[b];
      ic[p].m += ic[b].m;
      for (int k = 0; k < 3; k++) ic[p].h[k] += ic[b].h[k];
      for (int k = 0; k < 9; k++) ic[p].It[k] += ic[b].It[k];
    }
    for (int i = 0; i < MK_NV; i++) {
      float icd[6];
      unsigned int anc = M.body_dofs[M.dof_body[i]];
      inertia_apply(ic[M.dof_body[i]], cdof[i], icd);
      for (int j = 0; j <= i; j++) {
        float v = 0.0f;
        if (anc & (1u << j))
          for (int k = 0; k < 6; k++) v += cdof[j][k] * icd[k];
        Mq[MK_TRI(i, j)] = v;
      }
      Mq[MK_TRI(i, i)] += arma[i];
    }

    // ---- velocities: cvel per body, cdof_dot per dof
    for (int b = 0; b < MK_NBODY; b++) {
      for (int k = 0; k < 6; k++) cvel[b][k] = 0.0f;
      unsigned int anc = M.body_dofs[b];
      for (int v = 0; v < MK_NV; v++)
        if (anc & (1u << v))
          for (int k = 0; k < 6; k++) cvel[b][k] += cdof[v][k] * qvel[v];
    }
    for (int d = 0; d < MK_NV; d++) {
      float carrier[6] = {0, 0, 0, 0, 0, 0};
      unsigned int pred = M.dof_pred[d];
      for (int v = 0; v < MK_NV; v++)
        if (pred & (1u << v))
          for (int k = 0; k < 6; k++) carrier[k] += cdof[v][k] * qvel[v];
      motion_cross(carrier, cdof[d], cdof_dot[d]);
      for (int k = 0; k < 6; k++) cdof_dot[d][k] *= M.dof_ftm[d];
    }

    // ---- RNE bias: body forces, summed over subtrees, projected on cdof
    {
      float fsub[MK_NBODY][6];
      for (int b = 0; b < MK_NBODY; b++) {
        float cacc[6] = {0.0f, 0.0f, 0.0f, -M.gravity[0], -M.gravity[1], -M.gravity[2]};
        unsigned int anc = M.body_dofs[b];
        for (int v = 0; v < MK_NV; v++)
          if (anc & (1u << v))
            for (int k = 0; k < 6; k++) cacc[k] += cdof_dot[v][k] * qvel[v];
        float iv[6], ia[6], cf[6];
        inertia_apply(ib[b], cvel[b], iv);
        inertia_apply(ib[b], cacc, ia);
        motion_cross_force(cvel[b], iv, cf);
        for (int k = 0; k < 6; k++) fsub[b][k] = ia[k] + cf[k];
      }
      for (int b = MK_NBODY - 1; b > 0; b--) {
        int p = M.body_parent[b];
        for (int k = 0; k < 6; k++) fsub[p][k] += fsub[b][k];
      }
      for (int v = 0; v < MK_NV; v++) {
        float bias = 0.0f;
        for (int k = 0; k < 6; k++) bias += cdof[v][k] * fsub[M.dof_body[v]][k];
        qfrc[v] = -M.dof_damping[v] * qvel[v] - bias;
      }
    }

    // ---- position servos
    for (int u = 0; u < MK_NU; u++) {
      float c = mk_clamp(ctrl[u], M.act_ctrlrange[u][0], M.act_ctrlrange[u][1]);
      float f = gain0[u] * c + bias0[u] + bias1[u] * qpos[M.act_qadr[u]] +
                bias2[u] * qvel[M.act_dadr[u]];
      force[u] = mk_clamp(f, M.act_forcerange[u][0], M.act_forcerange[u][1]);
      qfrc[M.act_dadr[u]] += force[u];
    }

    // ---- unconstrained acceleration
    for (int i = 0; i < MK_NTRI; i++) H[i] = Mq[i];
    chol_packed(H);
    for (int v = 0; v < MK_NV; v++) qacc_smooth[v] = qfrc[v];
    chol_solve_packed(H, qacc_smooth);

    // ---- contacts: the KPTS deepest hull vertices of each foot
#if MK_HFIELD
    {
      int fb = M.floor_body;
      float fpos[3], t[3];
      quat_rot(xquat[fb], M.floor_gpos, t);
      for (int k = 0; k < 3; k++) fpos[k] = xpos[fb][k] + t[k];
      for (int f = 0; f < MK_NFOOT; f++) {
        int b = M.foot_body[f];
        float gpos[3], gquat[4], vert[MK_NVERT][3], d[MK_NVERT], nv[3];
        quat_rot(xquat[b], M.foot_gpos[f], t);
        for (int k = 0; k < 3; k++) gpos[k] = xpos[b][k] + t[k];
        quat_mul(xquat[b], M.foot_gquat[f], gquat);
        for (int v = 0; v < MK_NVERT; v++) {
          quat_rot(gquat, M.foot_hull[f][v], t);
          for (int k = 0; k < 3; k++) vert[v][k] = gpos[k] + t[k];
          // height above the triangle under the vertex, onto its normal
          float h = hfield_height_normal(M, a.hfield, vert[v][0] - fpos[0], vert[v][1] - fpos[1], nv);
          d[v] = ((vert[v][2] - fpos[2]) - h) * nv[2];
        }
        unsigned int used = 0u;
        for (int s = 0; s < MK_KPTS; s++) {
          int best = -1;
          for (int v = 0; v < MK_NVERT; v++) {
            if (used & (1u << v)) continue;
            if (best < 0 || d[v] < d[best]) best = v;
          }
          used |= 1u << best;
          int c = f * MK_KPTS + s;
          // the chosen vertex's normal again, rather than one kept per vertex
          hfield_height_normal(M, a.hfield, vert[best][0] - fpos[0], vert[best][1] - fpos[1], normal[c]);
          con_dist[c] = d[best];
          for (int k = 0; k < 3; k++) con_pos[c][k] = vert[best][k] - 0.5f * d[best] * normal[c][k];
          // tangent frame (mju_makeFrame): reference axis least aligned with n
          float r[3] = {0.0f, 0.0f, 0.0f};
          r[fabsf(normal[c][0]) <= fabsf(normal[c][1]) ? 0 : 1] = 1.0f;
          cross3(normal[c], r, t1[c]);
          float n1 = sqrtf(dot3(t1[c], t1[c]));
          for (int k = 0; k < 3; k++) t1[c][k] /= n1;
          cross3(normal[c], t1[c], t2[c]);
        }
      }
    }
#else
    {
      int fb = M.floor_body;
      float fpos[3], fquat[4], t[3];
      const float ez[3] = {0.0f, 0.0f, 1.0f};
      quat_rot(xquat[fb], M.floor_gpos, t);
      for (int k = 0; k < 3; k++) fpos[k] = xpos[fb][k] + t[k];
      quat_mul(xquat[fb], M.floor_gquat, fquat);
      quat_rot(fquat, ez, normal);
      for (int f = 0; f < MK_NFOOT; f++) {
        int b = M.foot_body[f];
        float gpos[3], gquat[4], vert[MK_NVERT][3], d[MK_NVERT];
        quat_rot(xquat[b], M.foot_gpos[f], t);
        for (int k = 0; k < 3; k++) gpos[k] = xpos[b][k] + t[k];
        quat_mul(xquat[b], M.foot_gquat[f], gquat);
        for (int v = 0; v < MK_NVERT; v++) {
          quat_rot(gquat, M.foot_hull[f][v], t);
          float rel[3];
          for (int k = 0; k < 3; k++) {
            vert[v][k] = gpos[k] + t[k];
            rel[k] = vert[v][k] - fpos[k];
          }
          d[v] = dot3(rel, normal);
        }
        unsigned int used = 0u;
        for (int s = 0; s < MK_KPTS; s++) {
          int best = -1;
          for (int v = 0; v < MK_NVERT; v++) {
            if (used & (1u << v)) continue;
            if (best < 0 || d[v] < d[best]) best = v;
          }
          used |= 1u << best;
          int c = f * MK_KPTS + s;
          con_dist[c] = d[best];
          for (int k = 0; k < 3; k++) con_pos[c][k] = vert[best][k] - 0.5f * d[best] * normal[k];
        }
      }
      // tangent frame (mju_makeFrame): reference axis least aligned with n
      float r[3] = {0.0f, 0.0f, 0.0f};
      r[fabsf(normal[0]) <= fabsf(normal[1]) ? 0 : 1] = 1.0f;
      cross3(normal, r, t1);
      float n1 = sqrtf(dot3(t1, t1));
      for (int k = 0; k < 3; k++) t1[k] /= n1;
      cross3(normal, t1, t2);
    }
#endif

    // ---- constraint rows
    for (int i = 0; i < MK_NFRIC; i++) {
      int dof = M.fric_dof[i];
      rows.dof[i] = dof;
      rows.sign[i] = 1.0f;
      rows.aref[i] = -M.fric_b[i] * qvel[dof];
      rows.R[i] = M.fric_R[i];
      rows.D[i] = 1.0f / M.fric_R[i];
      rows.fl[i] = fl[dof];
      rows.active[i] = 1;
    }
    for (int l = 0; l < MK_NLIM; l++) {
      int i = MK_NFRIC + l, dof = M.lim_dadr[l];
      float q = qpos[M.lim_qadr[l]];
      float dlo = q - M.lim_range[l][0], dhi = M.lim_range[l][1] - q;
      float sign = dlo < dhi ? 1.0f : -1.0f;
      float dist = dlo < dhi ? dlo : dhi;
      float pos = dist - M.lim_margin[l];
      float imp = impedance(M.lim_solimp[l], pos);
      rows.dof[i] = dof;
      rows.sign[i] = sign;
      rows.R[i] = mk_max((1 - imp) / imp * M.lim_invw[l], MK_MINVAL);
      rows.fl[i] = 0.0f;
      rows.active[i] = dist < M.lim_margin[l];
      rows.aref[i] = rows.active[i] ? -M.lim_b[l] * sign * qvel[dof] - M.lim_k[l] * imp * pos : 0.0f;
      rows.D[i] = rows.active[i] ? 1.0f / rows.R[i] : 0.0f;
    }
    for (int c = 0; c < MK_NCON; c++) {
      int f = c / MK_KPTS, fb = M.foot_body[f];
      float dist = con_dist[c];
      bool active = dist < 0.0f;
      float imp = impedance(M.con_solimp, dist);
      float mu2 = mu * mu;
      float diag = 2.0f * mu2 * (1.0f + mu2) * M.foot_invw[f];
      float Rc = mk_max((1 - imp) / imp * diag, MK_MINVAL);
      float dirs[4][3];
      for (int tt = 0; tt < 2; tt++)
        for (int sg = 0; sg < 2; sg++)
          for (int k = 0; k < 3; k++)
            dirs[2 * tt + sg][k] =
                MK_CN(c)[k] + ((sg ? -1.0f : 1.0f) * mu) * (tt ? MK_CT2(c)[k] : MK_CT1(c)[k]);
      float rel[3];
      for (int k = 0; k < 3; k++) rel[k] = con_pos[c][k] - com[k];
      unsigned int anc = M.body_dofs[fb];
      for (int fc = 0; fc < 4; fc++) {
        int i = MK_NROW1 + 4 * c + fc;
        float* J = rows.J[4 * c + fc];
        float vel = 0.0f;
        for (int v = 0; v < MK_NV; v++) {
          float jv = 0.0f;
          if (active && (anc & (1u << v))) {
            float jp[3];
            cross3(cdof[v], rel, jp);
            for (int k = 0; k < 3; k++) jp[k] += cdof[v][3 + k];
            jv = dot3(dirs[fc], jp);
          }
          J[v] = jv;
          vel += jv * qvel[v];
        }
        rows.active[i] = active;
        rows.R[i] = Rc;
        rows.fl[i] = 0.0f;
        rows.aref[i] = active ? -M.con_b * vel - M.con_k * imp * dist : 0.0f;
        rows.D[i] = active ? 1.0f / Rc : 0.0f;
      }
    }

    // ---- Newton solve from the better of warmstart and qacc_smooth
    {
      float c_w = total_cost(rows, Mq, qacc_smooth, warm);
      float c_s = total_cost(rows, Mq, qacc_smooth, qacc_smooth);
      for (int v = 0; v < MK_NV; v++) qacc[v] = c_w < c_s ? warm[v] : qacc_smooth[v];
    }
    for (int it = 0; it < M.iterations; it++) {
      float jar[MK_NEFC], g[MK_NEFC], h[MK_NEFC];
      float xa[MK_NV], Mxa[MK_NV], grad[MK_NV], dx[MK_NV], mv[MK_NV];
      for (int v = 0; v < MK_NV; v++) xa[v] = qacc[v] - qacc_smooth[v];
      symv_packed(Mq, xa, Mxa);
      for (int v = 0; v < MK_NV; v++) grad[v] = Mxa[v];
      for (int i = 0; i < MK_NTRI; i++) H[i] = Mq[i];
      for (int i = 0; i < MK_NEFC; i++) {
        jar[i] = 0.0f;
        g[i] = h[i] = 0.0f;
        if (!rows.active[i]) continue;
        jar[i] = row_jx(rows, i, qacc) - rows.aref[i];
        row_gh(rows, i, jar[i], &g[i], &h[i]);
        if (i < MK_NROW1) {
          int dof = rows.dof[i];
          grad[dof] += rows.sign[i] * g[i];
          H[MK_TRI(dof, dof)] += h[i];
        } else {
          const float* J = rows.J[i - MK_NROW1];
          for (int v = 0; v < MK_NV; v++) grad[v] += J[v] * g[i];
          if (h[i] != 0.0f)
            for (int p = 0; p < MK_NV; p++) {
              if (J[p] == 0.0f) continue;
              float hp = J[p] * h[i];
              for (int q = 0; q <= p; q++) H[MK_TRI(p, q)] += hp * J[q];
            }
        }
      }
      chol_packed(H);
      for (int v = 0; v < MK_NV; v++) dx[v] = grad[v];
      chol_solve_packed(H, dx);
      for (int v = 0; v < MK_NV; v++) dx[v] = -dx[v];

      float jv[MK_NEFC];
      for (int i = 0; i < MK_NEFC; i++) jv[i] = rows.active[i] ? row_jx(rows, i, dx) : 0.0f;
      symv_packed(Mq, dx, mv);
      float g0 = 0.0f, hq = 0.0f;
      for (int v = 0; v < MK_NV; v++) {
        g0 += dx[v] * Mxa[v];
        hq += dx[v] * mv[v];
      }
      float alpha = 0.0f;
      for (int ls = 0; ls < M.ls_iterations; ls++) {
        float dphi = 0.0f, ddphi = 0.0f;
        for (int i = 0; i < MK_NEFC; i++) {
          if (!rows.active[i]) continue;
          float gi, hi;
          row_gh(rows, i, jar[i] + alpha * jv[i], &gi, &hi);
          dphi += jv[i] * gi;
          ddphi += hi * jv[i] * jv[i];
        }
        dphi = g0 + alpha * hq + dphi;
        ddphi = hq + ddphi;
        alpha = alpha - dphi / mk_max(ddphi, 1e-12f);
      }
      for (int v = 0; v < MK_NV; v++) qacc[v] = qacc[v] + alpha * dx[v];
    }

    // ---- last substep: site poses, sensors and the derived outputs
    if (last) {
      float sxp[MK_NSITE][3], sxm[MK_NSITE][9];
      for (int s = 0; s < MK_NSITE; s++) {
        int b = M.site_body[s];
        float t[3], q[4];
        quat_rot(xquat[b], M.site_pos[s], t);
        for (int k = 0; k < 3; k++) sxp[s][k] = xpos[b][k] + t[k];
        quat_mul(xquat[b], M.site_quat[s], q);
        quat_mat(q, sxm[s]);
        for (int k = 0; k < 3; k++) a.o_site_xpos[((long)e * MK_NSITE + s) * 3 + k] = sxp[s][k];
        for (int k = 0; k < 9; k++) a.o_site_xmat[((long)e * MK_NSITE + s) * 9 + k] = sxm[s][k];
      }
      float* sd = a.o_sensordata + (long)e * MK_NSENSDATA;
      for (int si = 0; si < MK_NSENSOR; si++) {
        int s = M.sensor_obj[si], b = M.site_body[s], adr = M.sensor_adr[si];
        const float* p = sxp[s];
        const float* R = sxm[s];
        float rel[3], wr[3], vp[3], w[3];
        for (int k = 0; k < 3; k++) {
          rel[k] = p[k] - com[k];
          w[k] = cvel[b][k];
        }
        cross3(w, rel, wr);
        for (int k = 0; k < 3; k++) vp[k] = cvel[b][3 + k] + wr[k];
        switch (M.sensor_kind[si]) {
          case MK_GYRO:
          case MK_VELOCIMETER:
          case MK_ACCELEROMETER: {
            float vec[3];
            if (M.sensor_kind[si] == MK_GYRO) {
              for (int k = 0; k < 3; k++) vec[k] = w[k];
            } else if (M.sensor_kind[si] == MK_VELOCIMETER) {
              for (int k = 0; k < 3; k++) vec[k] = vp[k];
            } else {
              // body acceleration after the solve (mj_rnePostConstraint)
              float cacc[6] = {0.0f, 0.0f, 0.0f, -M.gravity[0], -M.gravity[1], -M.gravity[2]};
              unsigned int anc = M.body_dofs[b];
              for (int v = 0; v < MK_NV; v++)
                if (anc & (1u << v))
                  for (int k = 0; k < 6; k++)
                    cacc[k] += cdof_dot[v][k] * qvel[v] + cdof[v][k] * qacc[v];
              float x1[3], x2[3];
              cross3(cacc, rel, x1);
              cross3(w, vp, x2);
              for (int k = 0; k < 3; k++) vec[k] = cacc[3 + k] + x1[k] + x2[k];
            }
            for (int k = 0; k < 3; k++)
              sd[adr + k] = R[k] * vec[0] + R[3 + k] * vec[1] + R[6 + k] * vec[2];
            break;
          }
          case MK_FRAMEZAXIS:
            for (int k = 0; k < 3; k++) sd[adr + k] = R[3 * k + 2];
            break;
          case MK_FRAMEXAXIS:
            for (int k = 0; k < 3; k++) sd[adr + k] = R[3 * k];
            break;
          case MK_FRAMELINVEL:
            for (int k = 0; k < 3; k++) sd[adr + k] = vp[k];
            break;
          case MK_FRAMEANGVEL:
            for (int k = 0; k < 3; k++) sd[adr + k] = w[k];
            break;
          case MK_FRAMEPOS:
            for (int k = 0; k < 3; k++) sd[adr + k] = p[k];
            break;
          case MK_FRAMEQUAT: {
            float q[4];
            quat_mul(xquat[b], M.site_quat[s], q);
            for (int k = 0; k < 4; k++) sd[adr + k] = q[k];
            break;
          }
        }
      }
      for (int u = 0; u < MK_NU; u++) a.o_actuator_force[(long)e * MK_NU + u] = force[u];
      for (int c = 0; c < MK_NCON; c++) a.o_contact_dist[(long)e * MK_NCON + c] = con_dist[c];
      for (int v = 0; v < MK_NV; v++) {
        a.o_qacc[(long)e * MK_NV + v] = qacc[v];
        a.o_warm[(long)e * MK_NV + v] = qacc[v];
      }
    }

    // ---- semi-implicit Euler
    for (int v = 0; v < MK_NV; v++) {
      qvel[v] = qvel[v] + dt * qacc[v];
      warm[v] = qacc[v];
    }
    for (int j = 0; j < MK_NJNT; j++) {
      int qa = M.jnt_qposadr[j], da = M.jnt_dofadr[j];
      if (M.jnt_type[j] == MK_HINGE) {
        qpos[qa] = qpos[qa] + dt * qvel[da];
        continue;
      }
      for (int k = 0; k < 3; k++) qpos[qa + k] = qpos[qa + k] + dt * qvel[da + k];
      const float* om = &qvel[da + 3];
      float angle = sqrtf(om[0] * om[0] + om[1] * om[1] + om[2] * om[2]);
      float dq[4] = {1.0f, 0.0f, 0.0f, 0.0f};
      if (!(angle < 1e-12f)) {
        float axis[3] = {om[0] / angle, om[1] / angle, om[2] / angle};
        axis_angle_quat(axis, angle * dt, dq);
      }
      float qn[4];
      quat_mul(&qpos[qa + 3], dq, qn);
      float nrm = sqrtf(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2] + qn[3] * qn[3]);
      for (int k = 0; k < 4; k++) qpos[qa + 3 + k] = qn[k] / nrm;
    }
  }

  for (int i = 0; i < MK_NQ; i++) a.o_qpos[(long)e * MK_NQ + i] = qpos[i];
  for (int v = 0; v < MK_NV; v++) a.o_qvel[(long)e * MK_NV + v] = qvel[v];
}
