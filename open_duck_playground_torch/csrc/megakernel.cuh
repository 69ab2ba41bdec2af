// Physics megakernel body: every substep of one control step for ONE env,
// computed by a group of lanes that share the env's working set.
//
// Replaces the Pallas TPU kernel of
// open_duck_playground_tpu/physics/megakernel.py:megakernel_step_batched
// (kernel body _build_kernel.<locals>.kernel). The math is that of the torch
// engine in physics/*.py (its plain version is forward.step_reference):
//   FK -> CoM/cdof -> composite-inertia mass matrix -> velocities -> RNE
//   bias -> passive + servo forces -> Cholesky -> hull-vs-floor contacts
//   (4 deepest vertices per foot) -> constraint rows (dof friction, joint
//   limits, pyramid facets) -> Newton (1 iteration, 5-step analytic
//   linesearch) -> sensors (last substep) -> semi-implicit Euler.
// The floor is a plane, or with -DMK_HFIELD=1 a heightfield (the IS_HFIELD
// branch of the TPU kernel): the height and the triangle normal under each
// hull vertex are gathered from the height table in device memory, one
// vertex per lane, so every contact has its own normal and tangent frame.
//
// Form, for an H100:
// - An env belongs to L lanes (L = the lane context's N: a warp or an aligned
//   part of one on the card; 1, or a few threads, in the host harness). Its
//   working set is one MkShared in shared memory: state, kinematics, both
//   matrices, the constraint rows.
//   It stays there across the substeps; device memory is read once and
//   written once per control step, consecutive lanes on consecutive
//   addresses. No thread-local array is indexed by a run-time value, so
//   nothing lives in local memory.
// - Every stage spreads its independent items over the lanes
//   (`for (i = lane; i < n; i += L)`): a body, a dof, a joint, a hull
//   vertex, a matrix entry, a constraint row per lane-iteration. FK walks
//   the tree level by level (bodies of a level side by side); subtree sums
//   (composite inertias, RNE forces) and ancestor sums (cvel, cdof_dot) run
//   over bit masks, one output entry per lane, in ascending order whatever
//   L is. Stages end in cx.sync(), a warp-level barrier: no block-wide
//   barrier is on the path. Sums over rows or bodies are lane partials
//   closed by cx.sum (an xor butterfly: every lane gets the same bits, and
//   the order depends on L alone, never on the launch). The deepest hull
//   vertices come from cx.argmin rounds.
// - Block-arrow forms: the dofs split into a root block [0, NROOT) and
//   NCHAIN serial chains that couple only through the root. Mq and H keep
//   the root triangle, each chain's triangle and its chain-to-root panel
//   (MK_NBA floats: 285 of the dense 465 on the duck). Cholesky factors the
//   chains side by side, solves each panel against its chain's factor,
//   gives the root the Schur complement and factors it last: dense Cholesky
//   in a permuted order, no fill-in. One reciprocal square root per pivot,
//   then multiplies. Loops over a chain's dofs are unrolled to its
//   compile-time length so that their loads leave together.
//   Contact Jacobians keep three base rows per contact (normal, t1, t2) on
//   the foot's support (root + its own chain, MK_NSUP columns); the four
//   pyramid facets are n +- mu t combinations wherever a row product, the
//   gradient or the Hessian needs them. A model without that shape takes
//   the degenerate partition (NROOT = 0, one chain of all dofs) and the
//   same code is then dense.
// - No tensor cores: the products are 10x10 and 6x6 blocks per env, and the
//   gates against the plain version (qpos 1e-4, qvel 1e-2 per substep with
//   a Newton step that is discontinuous at jar = 0) need true f32, which
//   TF32 does not give. No TMA or clusters either: an env moves 2.3 KB.
// - Shared-memory layout: arrays a lane walks with a stride are padded to
//   an odd stride (quaternions 5, spatial vectors 7, inertias 13) so that
//   consecutive lanes fall on different banks. Kinematic scratch (dead once
//   the bias force is known), the contact and row data of the solver, and
//   the staged site and sensor outputs share one union.
//
// Model dimensions and the partition's sizes are compile-time constants (-D
// flags from physics/megakernel.py), so every array has a fixed size. The
// structure tables are one MkModel, which a launch passes by pointer in
// MkArgs; the 8 domain-randomized fields come per env. The body is a
// template over the lane context and is __host__ __device__, so the same
// text compiles with a host C++ compiler (megakernel_host.cpp, a one-lane
// test harness). Lanes talk only through MkShared and the context's sync,
// sum and argmin.
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
    !defined(MK_KPTS) || !defined(MK_NFRIC) || !defined(MK_NLIM) ||                    \
    !defined(MK_NLEVEL) || !defined(MK_NROOT) || !defined(MK_NCHAIN) ||                \
    !defined(MK_MAXCHAIN) || !defined(MK_NBA)
#error "model dimensions must be given with -D flags (physics/megakernel.py)"
#endif

#ifndef MK_HFIELD
#define MK_HFIELD 0
#endif

#if MK_NV > 32 || MK_NVERT > 32 || MK_NBODY > 32
#error "dof, body and hull-vertex sets are 32-bit masks: nv, nbody and hull_nvert must be <= 32"
#endif

#define MK_NCON (MK_NFOOT * MK_KPTS)
#define MK_TRI(i, j) ((i) * ((i) + 1) / 2 + (j))  // packed lower triangle, i >= j
#define MK_NSUP (MK_NROOT + MK_MAXCHAIN)          // dofs a foot can move: root + its chain
#define MK_NSUPTRI (MK_NSUP * (MK_NSUP + 1) / 2)
#define MK_NROOTTRI (MK_NROOT * (MK_NROOT + 1) / 2)
#define MK_NCROW (MK_NV - MK_NROOT)               // rows of all chains

// Padded strides of shared-memory arrays walked one item per lane.
#define MK_S4 5
#define MK_S6 7
#define MK_SI 13  // spatial inertia: m, h[3], It[9]

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
// ctypes mirror in physics/megakernel.py:_struct_fields lists the same
// fields in the same order, and mk_model_size() lets the wrapper check the
// size. On the card the model's record in device memory is copied by every
// block into shared memory, not constant memory: lanes read different
// entries at once, which the constant cache serializes.
struct MkModel {
  int body_parent[MK_NBODY];
  int body_jntadr[MK_NBODY];
  int body_jntnum[MK_NBODY];
  float body_intree[MK_NBODY];          // 1 if any dof moves the body
  unsigned int body_dofs[MK_NBODY];     // bit d: dof d moves the body
  unsigned int body_sub[MK_NBODY];      // bit c: body c is in the subtree (itself included)
  int level_start[MK_NLEVEL + 1];       // level_body[level_start[l] .. level_start[l+1]):
  int level_body[MK_NBODY - 1];         //   the bodies at tree depth l + 1
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
  int dof_fric[MK_NV];                  // the dof's friction row, -1 without one
  int dof_lim[MK_NV];                   // the dof's joint-limit row (0-based among limits), -1 without
  // Block-arrow partition: root dofs [0, NROOT), then the chains.
  int chain_start[MK_NCHAIN];
  int chain_end[MK_NCHAIN];
  int dof_chain[MK_NV];                 // -1 on root dofs
  int ba_rowoff[MK_NV];                 // entry (i, j), i >= j, of a block-arrow matrix:
  int ba_shift[MK_NV];                  //   ba_rowoff[i] + j - (j >= NROOT ? ba_shift[i] : 0)
  int ba_ij[MK_NBA];                    // i | j << 8 of each stored entry
  int sup_ij[MK_NSUPTRI];               // s | t << 8 of the support triangle, s >= t
  int foot_chain[MK_NFOOT];
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
// body_ipos, floor friction). Outputs: the Data fields of the step. Last,
// the structure tables of the model stepped.
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
  const MkModel* model;
};

// Pointers of one launch, in MkArgs order: 14 inputs, the height table
// where there is one, 9 outputs.
#define MK_NPTR (23 + MK_HFIELD)

MK_HD inline MkArgs mk_args(const MkModel* model, const void* const* p, int batch, int n_substeps) {
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
  a.model = model;
  return a;
}

// Rows of the constraint problem. Rows [0, NFRIC) are dof friction, the
// next NLIM are joint limits (one-hot J: dof index and sign), the last
// NCON*4 are contact facets, facet 2*tt+sg of contact c being
// n + (sg ? -mu : mu) * (tt ? t2 : t1) on the contact's three base rows.
// Inactive rows have D = 0 and aref = 0 and give g = h = 0.
#define MK_NROW1 (MK_NFRIC + MK_NLIM)
#define MK_NEFC (MK_NROW1 + MK_NCON * 4)
#define MK_NCFRAME (MK_HFIELD ? MK_NCON : 1)  // one contact frame on a plane
#define MK_CI(c) (MK_HFIELD ? (c) : 0)

// Kinematic scratch: dead once the bias force qfrc is known.
struct MkKin {
  float jquat[MK_NJNT][MK_S4];          // rotation of each hinge about its axis
  float xanchor[MK_NJNT][3];
  float xaxis[MK_NJNT][3];
  float xipos[MK_NBODY][3];
  float ximat[MK_NBODY][9];
  float ib[MK_NBODY][MK_SI];            // body inertia about the CoM
  float ic[MK_NBODY][MK_SI];            // composite (subtree) inertia
  float icd[MK_NV][MK_S6];              // ic[dof_body[i]] applied to cdof[i]
  float fown[MK_NBODY][MK_S6];          // RNE force of the body alone
  float fsub[MK_NBODY][MK_S6];          // ... summed over its subtree
};

// Contacts and constraint rows: alive from the collision stage to the end
// of the Newton solve.
struct MkSolve {
  float fgpos[MK_NFOOT][3];
  float fgquat[MK_NFOOT][MK_S4];
  float fpos[3];
  float vert[MK_NFOOT * MK_NVERT][3];
  float vd[MK_NFOOT * MK_NVERT];
  int cvert[MK_NCON];                   // the hull vertex chosen for each contact
  float con_pos[MK_NCON][3];
  float normal[MK_NCFRAME][3];
  float t1[MK_NCFRAME][3];
  float t2[MK_NCFRAME][3];
  float Jc[MK_NCON][3][MK_NSUP];        // base rows n, t1, t2 on the foot's support
  float cb[MK_NCON][3];                 // base rows times the vector in hand
  float G[MK_NCON][3];                  // facet gradients folded onto the base rows
  float W[MK_NCON][6];                  // facet curvatures: nn, nt1, nt2, t1t1, t2t2 (t1t2 = 0)
  int rdof[MK_NROW1];
  float rsign[MK_NROW1];
  float aref[MK_NEFC];
  float D[MK_NEFC];
  float R[MK_NEFC];
  float fl[MK_NEFC];
  float jar[MK_NEFC];
  float jv[MK_NEFC];
  float g[MK_NEFC];
  float h[MK_NEFC];
  int active[MK_NEFC];
};

// Outputs of the last substep that are staged for a coalesced store.
struct MkStage {
  float sxp[MK_NSITE][3];
  float sxm[MK_NSITE][9];
  float sens[MK_NSENSDATA];
};

// One env's working set.
struct MkShared {
  float qpos[MK_NQ], qvel[MK_NV], ctrl[MK_NU], warm[MK_NV], qpos0[MK_NQ];
  float gain0[MK_NU], bias0[MK_NU], bias1[MK_NU], bias2[MK_NU];
  float fl[MK_NV], arma[MK_NV], mass[MK_NBODY], ipos[MK_NBODY][3];
  float mu;
  float xpos[MK_NBODY][3];
  float xquat[MK_NBODY][MK_S4];
  float cdof[MK_NV][MK_S6];
  float cdof_dot[MK_NV][MK_S6];
  float cvel[MK_NBODY][MK_S6];
  float Mq[MK_NBA];                     // mass matrix, block-arrow
  float H[MK_NBA];                      // its factor, then the Newton Hessian's
  float rinv[MK_NV];                    // 1 / pivot of the factor in H
  float qfrc[MK_NV], qacc_smooth[MK_NV], qacc[MK_NV];
  float xa[MK_NV], Mxa[MK_NV], grad[MK_NV], dx[MK_NV], mv[MK_NV];
  float force[MK_NU];
  float con_dist[MK_NCON];
  union {
    MkKin k;
    MkSolve s;
    MkStage o;
  } u;
};

// The lane context of the host harness and the model of the device one
// (megakernel.cu): N lanes own an env, `lane` is this one's index.
struct MkOneLane {
  static constexpr int N = 1;
  int lane = 0;
  MK_HD void sync() const {}
  MK_HD float sum(float v) const { return v; }           // over the lanes; same bits on every lane
  MK_HD int argmin(float, int idx) const { return idx; }  // index of the least value, lowest index on ties
};

// ------------------------------------------------------------------ helpers
// max/min/clamp that keep a NaN in x, as torch.clamp / jnp.maximum do, so
// a blown-up env stays visibly non-finite for the NaN quarantine.
MK_HD inline float mk_max(float x, float lo) { return (x != x || x > lo) ? x : lo; }
MK_HD inline float mk_min(float x, float hi) { return (x != x || x < hi) ? x : hi; }
MK_HD inline float mk_clamp(float x, float lo, float hi) { return mk_min(mk_max(x, lo), hi); }

// 1 / sqrt(x) of a floored pivot: the card's rsqrt (2 ulp) in place of an
// IEEE square root and an IEEE division on the factorization's critical path.
MK_HD inline float mk_rsqrt(float x) {
#ifdef __CUDA_ARCH__
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}

// Index of the lowest set bit of m != 0.
MK_HD inline int mk_ctz(unsigned int m) {
#ifdef __CUDA_ARCH__
  return __ffs((int)m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

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
  float x = v[0] + 2.0f * (q[0] * uv[0] + uuv[0]);
  float y = v[1] + 2.0f * (q[0] * uv[1] + uuv[1]);
  float z = v[2] + 2.0f * (q[0] * uv[2] + uuv[2]);
  o[0] = x;
  o[1] = y;
  o[2] = z;
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

// Spatial inertia about the CoM in compact form, I = (m, h[3], It[9]):
// mass m, first moment h = m c and the rotational block
// It = Ic + m (|c|^2 E - c c^T). I [w; u] = [It w + h x u; m u - h x w].
MK_HD inline void inertia_apply(const float* I, const float* v, float* o) {
  const float* h = I + 1;
  const float* It = I + 4;
  float hu[3], hw[3];
  cross3(h, v + 3, hu);
  cross3(h, v, hw);
#pragma unroll
  for (int r = 0; r < 3; r++) {
    o[r] = It[3 * r] * v[0] + It[3 * r + 1] * v[1] + It[3 * r + 2] * v[2] + hu[r];
    o[3 + r] = I[0] * v[3 + r] - hw[r];
  }
}

// v x m of motion vectors (angular, linear)
MK_HD inline void motion_cross(const float* v, const float* m, float* o) {
  float a[3], b[3], c[3];
  cross3(v, m, a);
  cross3(v, m + 3, b);
  cross3(v + 3, m, c);
#pragma unroll
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
#pragma unroll
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

// Tangent frame of a unit normal (mju_makeFrame): the reference axis is
// the one of x, y least aligned with n.
MK_HD inline void tangent_frame(const float* n, float* t1, float* t2) {
  bool x = fabsf(n[0]) <= fabsf(n[1]);
  float r[3] = {x ? 1.0f : 0.0f, x ? 0.0f : 1.0f, 0.0f};
  cross3(n, r, t1);
  float n1 = sqrtf(dot3(t1, t1));
  t1[0] /= n1;
  t1[1] /= n1;
  t1[2] /= n1;
  cross3(n, t1, t2);
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

// ------------------------------------------------------ block-arrow algebra
// Entry (i, j), i >= j, of a block-arrow matrix; j is a root dof or a dof of
// i's own chain.
MK_HD inline int ba_idx(const MkModel& M, int i, int j) {
  return M.ba_rowoff[i] + j - (j >= MK_NROOT ? M.ba_shift[i] : 0);
}

// Loops over the dofs of one chain run to the compile-time MK_MAXCHAIN with
// a predicate on the chain's own length and are fully unrolled where chains
// are short: their loads then leave together, ahead of the arithmetic that
// depends on them, instead of one shared-memory latency per step. The
// degenerate partition (one chain of all dofs) keeps them as loops.
#if MK_MAXCHAIN <= 12
#define MK_UNROLL_CHAIN _Pragma("unroll")
#else
#define MK_UNROLL_CHAIN _Pragma("unroll 1")
#endif
#define MK_NROOT1 (MK_NROOT > 0 ? MK_NROOT : 1)

// Offset of row lj of a chain whose first row starts at coff: the row holds
// its NROOT panel entries, then its lj + 1 chain entries. The inner loops
// below step from row to row with this rule instead of reading
// MkModel.ba_rowoff, which would put a load from device memory on every
// dependent step.
MK_HD inline int ba_crow(int coff, int lj) { return coff + lj * MK_NROOT + lj * (lj + 1) / 2; }

// y = A x, A symmetric block-arrow; one row per lane-iteration. The caller
// syncs before it reads y.
template <class L>
MK_HD inline void symv_ba(const MkModel& M, const L& cx, const float* __restrict__ A,
                          const float* __restrict__ x, float* __restrict__ y) {
  for (int i = cx.lane; i < MK_NV; i += L::N) {
    float s = 0.0f;
    if (i < MK_NROOT) {
#pragma unroll
      for (int j = 0; j < MK_NROOT; j++) s += A[j <= i ? MK_TRI(i, j) : MK_TRI(j, i)] * x[j];
      for (int c = 0; c < MK_NCHAIN; c++) {
        const int a0 = M.chain_start[c], n = M.chain_end[c] - a0, coff = M.ba_rowoff[a0];
        MK_UNROLL_CHAIN
        for (int lj = 0; lj < MK_MAXCHAIN; lj++)
          if (lj < n) s += A[ba_crow(coff, lj) + i] * x[a0 + lj];
      }
    } else {
      const int c = M.dof_chain[i], a0 = M.chain_start[c], n = M.chain_end[c] - a0, li = i - a0;
      const int coff = M.ba_rowoff[a0], row = ba_crow(coff, li);
#pragma unroll
      for (int r = 0; r < MK_NROOT; r++) s += A[row + r] * x[r];
      MK_UNROLL_CHAIN
      for (int lj = 0; lj < MK_MAXCHAIN; lj++)
        if (lj < n) s += A[lj <= li ? row + MK_NROOT + lj : ba_crow(coff, lj) + MK_NROOT + li] * x[a0 + lj];
    }
    y[i] = s;
  }
}

// xs = F_c^{-1} xs for the factor F_c of one chain (first row at coff, n
// dofs from a0), xs in registers.
MK_HD inline void chain_forward(const float* F, const float* rinv, int coff, int a0, int n,
                                float* xs) {
  MK_UNROLL_CHAIN
  for (int k = 0; k < MK_MAXCHAIN; k++)
    if (k < n) {
      const int row = ba_crow(coff, k) + MK_NROOT;
      float s = xs[k];
      MK_UNROLL_CHAIN
      for (int j = 0; j < k; j++) s -= F[row + j] * xs[j];
      xs[k] = s * rinv[a0 + k];
    }
}

// In-place Cholesky of a block-arrow matrix with the engine's pivot floor
// (linalg.cholesky); rinv gets 1 / pivot of every dof. Elimination order:
// every chain, then the root.
// - Chains: step k takes the k-th dof of all chains at once. Each chain row
//   is an item that one lane owns for the whole factorization (its offsets
//   stay in registers). One barrier per step: in step k a row reads column k
//   unscaled, scales by 1 / pivot in registers, updates its entries right of
//   column k, and the owner of row k + 1 takes the next pivot; the scaled
//   entry of column k is written one step later, when nobody reads that
//   column.
// - Panels: column r of a chain's panel is that chain's factor applied to
//   it by forward substitution, one (chain, r) per lane.
// - Root: its entries lose the panels' products (the Schur complement), one
//   entry per lane, and one lane factors the small block in registers.
// No two lanes ever write one entry.
template <class L>
MK_HD inline void chol_ba(const MkModel& M, const L& cx, float* A, float* rinv) {
  constexpr int NL = L::N;
  constexpr int NIT = (MK_NCROW + NL - 1) / NL;
  const int lane = cx.lane;
  // per chain row: its chain's first row offset, first dof and length, and
  // its index in the chain (len = 0: no row)
  int coff[NIT], a0[NIT], len[NIT], li[NIT];
  float pend[NIT];
#pragma unroll
  for (int n = 0; n < NIT; n++) {
    const int it = lane + n * NL;
    const int c = it < MK_NCROW ? M.dof_chain[MK_NROOT + it] : 0;
    a0[n] = M.chain_start[c];
    len[n] = it < MK_NCROW ? M.chain_end[c] - a0[n] : 0;
    li[n] = MK_NROOT + it - a0[n];
    coff[n] = M.ba_rowoff[a0[n]];
    pend[n] = 0.0f;
    if (li[n] == 0 && len[n] > 0) {  // the first pivot of the chain
      const int d = coff[n] + MK_NROOT;
      const float dd = mk_max(A[d], 1e-12f), ri = mk_rsqrt(dd);
      A[d] = dd * ri;
      rinv[a0[n]] = ri;
    }
  }
  cx.sync();
  for (int k = 0; k < MK_MAXCHAIN; k++) {
#pragma unroll
    for (int n = 0; n < NIT; n++) {
      if (k >= len[n]) continue;
      const float ri = rinv[a0[n] + k];
      const int l = li[n], rowl = ba_crow(coff[n], l) + MK_NROOT;
      if (l >= k && k > 0) A[rowl + k - 1] = pend[n];
      if (l > k) {
        const float lik = A[rowl + k] * ri;
        pend[n] = lik;
        // column k of the rows k+1..l and this row's entries right of k:
        // all loads first, then the updates, then the stores
        float colk[MK_MAXCHAIN], mine[MK_MAXCHAIN];
        MK_UNROLL_CHAIN
        for (int lj = 1; lj < MK_MAXCHAIN; lj++)
          if (lj > k && lj <= l) {
            colk[lj] = A[ba_crow(coff[n], lj) + MK_NROOT + k];
            mine[lj] = A[rowl + lj];
          }
        MK_UNROLL_CHAIN
        for (int lj = 1; lj < MK_MAXCHAIN; lj++)
          if (lj > k && lj <= l) {
            mine[lj] -= lik * (colk[lj] * ri);
            A[rowl + lj] = mine[lj];
          }
        if (l == k + 1) {
          const float dd = mk_max(A[rowl + l], 1e-12f), rl = mk_rsqrt(dd);
          A[rowl + l] = dd * rl;
          rinv[a0[n] + l] = rl;
        }
      }
    }
    cx.sync();
  }
  for (int it = lane; it < MK_NCHAIN * MK_NROOT; it += NL) {
    const int c = it / MK_NROOT1, r = it % MK_NROOT1;
    const int c0 = M.chain_start[c], n = M.chain_end[c] - c0, off = M.ba_rowoff[c0];
    float xs[MK_MAXCHAIN];
    MK_UNROLL_CHAIN
    for (int k = 0; k < MK_MAXCHAIN; k++) xs[k] = k < n ? A[ba_crow(off, k) + r] : 0.0f;
    chain_forward(A, rinv, off, c0, n, xs);
    MK_UNROLL_CHAIN
    for (int k = 0; k < MK_MAXCHAIN; k++)
      if (k < n) A[ba_crow(off, k) + r] = xs[k];
  }
  cx.sync();
  // Schur complement of the root block: one entry per lane-iteration
  for (int it = lane; it < MK_NROOTTRI; it += NL) {
    const int r = M.ba_ij[it] & 255, s = M.ba_ij[it] >> 8;
    float v = A[it];
    for (int c = 0; c < MK_NCHAIN; c++) {
      const int n = M.chain_end[c] - M.chain_start[c];
      int row = M.ba_rowoff[M.chain_start[c]];
      for (int lj = 0; lj < n; lj++) {
        v -= A[row + r] * A[row + s];
        row += MK_NROOT + lj + 1;
      }
    }
    A[it] = v;
  }
  cx.sync();
  // the root block is small and last: one lane factors it in registers
  // (the root triangle starts the array)
  if (lane == 0) {
    float T[MK_NROOTTRI + 1];
#pragma unroll
    for (int i = 0; i < MK_NROOTTRI; i++) T[i] = A[i];
#pragma unroll
    for (int k = 0; k < MK_NROOT; k++) {
      const float dd = mk_max(T[MK_TRI(k, k)], 1e-12f), ri = mk_rsqrt(dd);
      T[MK_TRI(k, k)] = dd * ri;
      rinv[k] = ri;
#pragma unroll
      for (int r = k + 1; r < MK_NROOT; r++) T[MK_TRI(r, k)] *= ri;
#pragma unroll
      for (int r = k + 1; r < MK_NROOT; r++)
#pragma unroll
        for (int j = k + 1; j <= r; j++) T[MK_TRI(r, j)] -= T[MK_TRI(r, k)] * T[MK_TRI(j, k)];
    }
#pragma unroll
    for (int i = 0; i < MK_NROOTTRI; i++) A[i] = T[i];
  }
  cx.sync();
}

// x = (F F^T)^{-1} b with the factor of chol_ba, in place on x (b on
// entry): chains forward (one chain per lane, its part of x in registers),
// the root's right-hand side, the root both ways, chains backward.
template <class L>
MK_HD inline void solve_ba(const MkModel& M, const L& cx, const float* __restrict__ F,
                           const float* __restrict__ rinv, float* __restrict__ x) {
  const int lane = cx.lane;
  constexpr int NL = L::N;
  for (int c = lane; c < MK_NCHAIN; c += NL) {
    const int a0 = M.chain_start[c], n = M.chain_end[c] - a0;
    const int coff = M.ba_rowoff[a0];
    float xs[MK_MAXCHAIN];
    MK_UNROLL_CHAIN
    for (int k = 0; k < MK_MAXCHAIN; k++) xs[k] = k < n ? x[a0 + k] : 0.0f;
    chain_forward(F, rinv, coff, a0, n, xs);
    MK_UNROLL_CHAIN
    for (int k = 0; k < MK_MAXCHAIN; k++)
      if (k < n) x[a0 + k] = xs[k];
  }
  cx.sync();
  for (int r = lane; r < MK_NROOT; r += NL) {
    float s = x[r];
    for (int c = 0; c < MK_NCHAIN; c++) {
      const int a0 = M.chain_start[c], n = M.chain_end[c] - a0;
      int row = M.ba_rowoff[a0] + r;
      for (int lj = 0; lj < n; lj++) {
        s -= F[row] * x[a0 + lj];
        row += MK_NROOT + lj + 1;
      }
    }
    x[r] = s;
  }
  cx.sync();
  if (lane == 0) {
    float xr[MK_NROOT1];
#pragma unroll
    for (int k = 0; k < MK_NROOT; k++) xr[k] = x[k];
#pragma unroll
    for (int k = 0; k < MK_NROOT; k++) {
      float s = xr[k];
#pragma unroll
      for (int j = 0; j < k; j++) s -= F[MK_TRI(k, j)] * xr[j];
      xr[k] = s * rinv[k];
    }
#pragma unroll
    for (int k = MK_NROOT - 1; k >= 0; k--) {
      float s = xr[k];
#pragma unroll
      for (int j = k + 1; j < MK_NROOT; j++) s -= F[MK_TRI(j, k)] * xr[j];
      xr[k] = s * rinv[k];
    }
#pragma unroll
    for (int k = 0; k < MK_NROOT; k++) x[k] = xr[k];
  }
  cx.sync();
  for (int c = lane; c < MK_NCHAIN; c += NL) {
    const int a0 = M.chain_start[c], n = M.chain_end[c] - a0;
    const int coff = M.ba_rowoff[a0];
    float xs[MK_MAXCHAIN], xr[MK_NROOT1];
#pragma unroll
    for (int r = 0; r < MK_NROOT; r++) xr[r] = x[r];
    MK_UNROLL_CHAIN
    for (int k = 0; k < MK_MAXCHAIN; k++) xs[k] = k < n ? x[a0 + k] : 0.0f;
    MK_UNROLL_CHAIN
    for (int kk = 0; kk < MK_MAXCHAIN; kk++) {
      const int k = MK_MAXCHAIN - 1 - kk;
      if (k < n) {
        const int row = ba_crow(coff, k);
        float s = xs[k];
#pragma unroll
        for (int r = 0; r < MK_NROOT; r++) s -= F[row + r] * xr[r];
        MK_UNROLL_CHAIN
        for (int j = k + 1; j < MK_MAXCHAIN; j++)
          if (j < n) s -= F[ba_crow(coff, j) + MK_NROOT + k] * xs[j];
        xs[k] = s * rinv[a0 + k];
      }
    }
    MK_UNROLL_CHAIN
    for (int k = 0; k < MK_MAXCHAIN; k++)
      if (k < n) x[a0 + k] = xs[k];
  }
  cx.sync();
}

// ------------------------------------------------------------ constraint rows
// Dof of column s of foot f's support, -1 past the end of its chain.
MK_HD inline int sup_dof(const MkModel& M, int f, int s) {
  if (s < MK_NROOT) return s;
  const int c = M.foot_chain[f];
  const int v = M.chain_start[c] + s - MK_NROOT;
  return v < M.chain_end[c] ? v : -1;
}

// Column of dof v in foot f's support, -1 when the foot's rows have none.
MK_HD inline int sup_col(const MkModel& M, int f, int v) {
  if (v < MK_NROOT) return v;
  const int c = M.foot_chain[f];
  return M.dof_chain[v] == c ? MK_NROOT + v - M.chain_start[c] : -1;
}

// cb[c][b] = base row b of contact c times x; one product per
// lane-iteration. The caller syncs.
template <class L>
MK_HD inline void contact_base(const MkModel& M, const L& cx, MkSolve& R, const float* x) {
  for (int it = cx.lane; it < MK_NCON * 3; it += L::N) {
    const int c = it / 3, b = it % 3, fc = M.foot_chain[c / MK_KPTS];
    const int a0 = M.chain_start[fc], n = M.chain_end[fc] - a0;
    float s = 0.0f;
    if (R.active[MK_NROW1 + 4 * c]) {
      const float* J = R.Jc[c][b];
#pragma unroll
      for (int q = 0; q < MK_NROOT; q++) s += J[q] * x[q];
      MK_UNROLL_CHAIN
      for (int q = 0; q < MK_MAXCHAIN; q++)
        if (q < n) s += J[MK_NROOT + q] * x[a0 + q];
    }
    R.cb[c][b] = s;
  }
}

// out[i] = row i of J times x for every active row (0 on the others).
template <class L>
MK_HD inline void rows_jx(const MkModel& M, const L& cx, MkSolve& R, float mu, const float* x,
                          float* out) {
  contact_base(M, cx, R, x);
  cx.sync();
  for (int i = cx.lane; i < MK_NEFC; i += L::N) {
    float v = 0.0f;
    if (R.active[i]) {
      if (i < MK_NROW1) {
        v = R.rsign[i] * x[R.rdof[i]];
      } else {
        const int c = (i - MK_NROW1) / 4, fc = (i - MK_NROW1) % 4;
        v = R.cb[c][0] + ((fc & 1) ? -mu : mu) * R.cb[c][1 + (fc >> 1)];
      }
    }
    out[i] = v;
  }
  cx.sync();
}

// dc/djar and d2c/djar2 of one row (solver._force_and_hess)
MK_HD inline void row_gh(const MkSolve& r, int i, float jar, float* g, float* h) {
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

MK_HD inline float row_cost(const MkSolve& r, int i, float jar) {
  float fl = r.fl[i], D = r.D[i];
  float quad = 0.5f * D * jar * jar;
  if (fl > 0) {
    float lin = fl * fabsf(jar) - 0.5f * fl * fl * r.R[i];
    return fabsf(D * jar) < fl ? quad : lin;
  }
  return jar < 0 ? quad : 0.0f;
}

// Constraint cost of the active rows at jx = J x.
template <class L>
MK_HD inline float rows_cost(const L& cx, const MkSolve& R, const float* jx) {
  float c = 0.0f;
  for (int i = cx.lane; i < MK_NEFC; i += L::N)
    if (R.active[i]) c += row_cost(R, i, jx[i] - R.aref[i]);
  return cx.sum(c);
}

// ------------------------------------------------------------ one env step
template <class L>
MK_HD inline void mk_env_step(const MkModel& M, const MkArgs& a, int e, MkShared& S, const L& cx) {
  const int lane = cx.lane;
  constexpr int NL = L::N;
  MkKin& K = S.u.k;
  MkSolve& R = S.u.s;
  const long eo = e;

  // ---- load: consecutive lanes on consecutive addresses
  for (int i = lane; i < MK_NQ; i += NL) {
    S.qpos[i] = a.qpos[eo * MK_NQ + i];
    S.qpos0[i] = a.qpos0[eo * MK_NQ + i];
  }
  for (int i = lane; i < MK_NV; i += NL) {
    S.qvel[i] = a.qvel[eo * MK_NV + i];
    S.warm[i] = a.warm[eo * MK_NV + i];
    S.fl[i] = a.frictionloss[eo * MK_NV + i];
    S.arma[i] = a.armature[eo * MK_NV + i];
  }
  for (int i = lane; i < MK_NU; i += NL) {
    S.ctrl[i] = a.ctrl[eo * MK_NU + i];
    S.gain0[i] = a.gain0[eo * MK_NU + i];
    S.bias0[i] = a.bias0[eo * MK_NU + i];
    S.bias1[i] = a.bias1[eo * MK_NU + i];
    S.bias2[i] = a.bias2[eo * MK_NU + i];
  }
  for (int i = lane; i < MK_NBODY; i += NL) S.mass[i] = a.mass[eo * MK_NBODY + i];
  for (int i = lane; i < MK_NBODY * 3; i += NL) (&S.ipos[0][0])[i] = a.ipos[eo * MK_NBODY * 3 + i];
  if (lane == 0) S.mu = a.mu[e];
  cx.sync();
  const float mu = S.mu;
  const float dt = M.timestep;

  for (int sub = 0; sub < a.n_substeps; sub++) {
    const bool last = sub == a.n_substeps - 1;

    // ---- forward kinematics: hinge rotations side by side, then the tree
    // level by level (the bodies of a level are independent)
    for (int j = lane; j < MK_NJNT; j += NL) {
      if (M.jnt_type[j] == MK_FREE) continue;
      const int qa = M.jnt_qposadr[j];
      float q[4];
      axis_angle_quat(M.jnt_axis[j], S.qpos[qa] - S.qpos0[qa], q);
#pragma unroll
      for (int k = 0; k < 4; k++) K.jquat[j][k] = q[k];
    }
    if (lane == 0) {
      S.xpos[0][0] = S.xpos[0][1] = S.xpos[0][2] = 0.0f;
      S.xquat[0][0] = 1.0f;
      S.xquat[0][1] = S.xquat[0][2] = S.xquat[0][3] = 0.0f;
    }
    cx.sync();
    for (int lv = 0; lv < MK_NLEVEL; lv++) {
      for (int it = M.level_start[lv] + lane; it < M.level_start[lv + 1]; it += NL) {
        const int b = M.level_body[it], p = M.body_parent[b];
        float pos[3], quat[4], t[3];
        quat_rot(S.xquat[p], M.body_pos[b], t);
#pragma unroll
        for (int k = 0; k < 3; k++) pos[k] = S.xpos[p][k] + t[k];
        quat_mul(S.xquat[p], M.body_quat[b], quat);
        for (int jj = 0; jj < M.body_jntnum[b]; jj++) {
          const int j = M.body_jntadr[b] + jj;
          const int qa = M.jnt_qposadr[j];
          if (M.jnt_type[j] == MK_FREE) {
            const float* q = &S.qpos[qa];
            float nrm = sqrtf(q[3] * q[3] + q[4] * q[4] + q[5] * q[5] + q[6] * q[6]);
#pragma unroll
            for (int k = 0; k < 3; k++) pos[k] = q[k];
#pragma unroll
            for (int k = 0; k < 4; k++) quat[k] = q[3 + k] / nrm;
#pragma unroll
            for (int k = 0; k < 3; k++) {
              K.xanchor[j][k] = pos[k];
              K.xaxis[j][k] = k == 2 ? 1.0f : 0.0f;
            }
          } else {
            float anchor[3], ax[3], qn[4];
            quat_rot(quat, M.jnt_pos[j], t);
#pragma unroll
            for (int k = 0; k < 3; k++) anchor[k] = pos[k] + t[k];
            quat_rot(quat, M.jnt_axis[j], ax);
            quat_mul(quat, K.jquat[j], qn);
            quat_rot(qn, M.jnt_pos[j], t);
#pragma unroll
            for (int k = 0; k < 3; k++) {
              pos[k] = anchor[k] - t[k];
              K.xanchor[j][k] = anchor[k];
              K.xaxis[j][k] = ax[k];
            }
#pragma unroll
            for (int k = 0; k < 4; k++) quat[k] = qn[k];
          }
        }
#pragma unroll
        for (int k = 0; k < 3; k++) S.xpos[b][k] = pos[k];
#pragma unroll
        for (int k = 0; k < 4; k++) S.xquat[b][k] = quat[k];
      }
      cx.sync();
    }

    // ---- inertial frames and the CoM: one body per lane-iteration
    float com[3];
    {
      float wsum = 0.0f, acc[3] = {0.0f, 0.0f, 0.0f};
      for (int b = lane; b < MK_NBODY; b += NL) {
        float t[3], qi[4], R9[9];
        quat_rot(S.xquat[b], S.ipos[b], t);
        quat_mul(S.xquat[b], M.body_iquat[b], qi);
        quat_mat(qi, R9);
        const float w = S.mass[b] * M.body_intree[b];
        wsum += w;
#pragma unroll
        for (int k = 0; k < 3; k++) {
          K.xipos[b][k] = S.xpos[b][k] + t[k];
          acc[k] += w * (S.xpos[b][k] + t[k]);
        }
#pragma unroll
        for (int k = 0; k < 9; k++) K.ximat[b][k] = R9[k];
      }
      wsum = cx.sum(wsum);
#pragma unroll
      for (int k = 0; k < 3; k++) com[k] = cx.sum(acc[k]) / wsum;
    }

    // ---- cdof: one joint per lane-iteration
    for (int j = lane; j < MK_NJNT; j += NL) {
      const int d = M.jnt_dofadr[j];
      float r[3];
#pragma unroll
      for (int k = 0; k < 3; k++) r[k] = com[k] - K.xanchor[j][k];
      if (M.jnt_type[j] == MK_FREE) {
        float R9[9];
        quat_mat(S.xquat[M.jnt_bodyid[j]], R9);
#pragma unroll
        for (int i = 0; i < 3; i++) {
          float ax[3] = {R9[i], R9[3 + i], R9[6 + i]}, lin[3];
          cross3(ax, r, lin);
#pragma unroll
          for (int k = 0; k < 3; k++) {
            S.cdof[d + i][k] = 0.0f;
            S.cdof[d + i][3 + k] = k == i ? 1.0f : 0.0f;
            S.cdof[d + 3 + i][k] = ax[k];
            S.cdof[d + 3 + i][3 + k] = lin[k];
          }
        }
      } else {
        float lin[3];
        cross3(K.xaxis[j], r, lin);
#pragma unroll
        for (int k = 0; k < 3; k++) {
          S.cdof[d][k] = K.xaxis[j][k];
          S.cdof[d][3 + k] = lin[k];
        }
      }
    }

    // ---- body inertias about the CoM
    for (int b = lane; b < MK_NBODY; b += NL) {
      float c[3];
#pragma unroll
      for (int k = 0; k < 3; k++) c[k] = K.xipos[b][k] - com[k];
      const float* R9 = K.ximat[b];
      const float m = S.mass[b], cc = dot3(c, c);
      float* I = K.ib[b];
      I[0] = m;
#pragma unroll
      for (int k = 0; k < 3; k++) I[1 + k] = m * c[k];
#pragma unroll
      for (int r = 0; r < 3; r++)
#pragma unroll
        for (int s = 0; s < 3; s++) {
          float v = 0.0f;
#pragma unroll
          for (int k = 0; k < 3; k++) v += R9[3 * r + k] * (M.body_inertia[b][k] * R9[3 * s + k]);
          I[4 + 3 * r + s] = v + m * ((r == s ? cc : 0.0f) - c[r] * c[s]);
        }
    }
    cx.sync();

    // ---- composite inertias: one component of one body per lane-iteration,
    // summed over the body's subtree
    for (int it = lane; it < MK_NBODY * MK_SI; it += NL) {
      const int b = it / MK_SI, k = it % MK_SI;
      const unsigned int sub = M.body_sub[b];
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < MK_NBODY; d++)
        if (sub >> d & 1) s += K.ib[d][k];
      K.ic[b][k] = s;
    }
    // ---- cvel: one component of one body; servo forces: one actuator
    for (int it = lane; it < MK_NBODY * 6; it += NL) {
      const int b = it / 6, k = it % 6;
      const unsigned int dofs = M.body_dofs[b];
      float s = 0.0f;
#pragma unroll
      for (int v = 0; v < MK_NV; v++)
        if (dofs >> v & 1) s += S.cdof[v][k] * S.qvel[v];
      S.cvel[b][k] = s;
    }
    for (int u = lane; u < MK_NU; u += NL) {
      float c = mk_clamp(S.ctrl[u], M.act_ctrlrange[u][0], M.act_ctrlrange[u][1]);
      float f = S.gain0[u] * c + S.bias0[u] + S.bias1[u] * S.qpos[M.act_qadr[u]] +
                S.bias2[u] * S.qvel[M.act_dadr[u]];
      S.force[u] = mk_clamp(f, M.act_forcerange[u][0], M.act_forcerange[u][1]);
    }
    // ---- cdof_dot: one dof per lane-iteration
    for (int d = lane; d < MK_NV; d += NL) {
      float carrier[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, o[6];
      for (unsigned int m = M.dof_pred[d]; m; m &= m - 1) {
        const int v = mk_ctz(m);
        const float qv = S.qvel[v];
#pragma unroll
        for (int k = 0; k < 6; k++) carrier[k] += S.cdof[v][k] * qv;
      }
      motion_cross(carrier, S.cdof[d], o);
      const float ftm = M.dof_ftm[d];
#pragma unroll
      for (int k = 0; k < 6; k++) S.cdof_dot[d][k] = o[k] * ftm;
    }
    cx.sync();

    // ---- mass matrix: ic[dof_body[i]] cdof[i] per dof, then one stored
    // entry per lane-iteration
    for (int i = lane; i < MK_NV; i += NL) {
      float o[6];
      inertia_apply(K.ic[M.dof_body[i]], S.cdof[i], o);
#pragma unroll
      for (int k = 0; k < 6; k++) K.icd[i][k] = o[k];
    }
    // ---- RNE: the force of each body alone
    for (int b = lane; b < MK_NBODY; b += NL) {
      float cacc[6] = {0.0f, 0.0f, 0.0f, -M.gravity[0], -M.gravity[1], -M.gravity[2]};
      for (unsigned int m = M.body_dofs[b]; m; m &= m - 1) {
        const int v = mk_ctz(m);
        const float qv = S.qvel[v];
#pragma unroll
        for (int k = 0; k < 6; k++) cacc[k] += S.cdof_dot[v][k] * qv;
      }
      float cv[6], iv[6], ia[6], cf[6];
#pragma unroll
      for (int k = 0; k < 6; k++) cv[k] = S.cvel[b][k];
      inertia_apply(K.ib[b], cv, iv);
      inertia_apply(K.ib[b], cacc, ia);
      motion_cross_force(cv, iv, cf);
#pragma unroll
      for (int k = 0; k < 6; k++) K.fown[b][k] = ia[k] + cf[k];
    }
    cx.sync();
    for (int it = lane; it < MK_NBA; it += NL) {
      const int i = M.ba_ij[it] & 255, j = M.ba_ij[it] >> 8;
      float v = 0.0f;
      if (M.body_dofs[M.dof_body[i]] & (1u << j)) {
#pragma unroll
        for (int k = 0; k < 6; k++) v += S.cdof[j][k] * K.icd[i][k];
      }
      if (i == j) v += S.arma[i];
      S.Mq[it] = v;
      S.H[it] = v;
    }
    for (int it = lane; it < MK_NBODY * 6; it += NL) {
      const int b = it / 6, k = it % 6;
      const unsigned int sub = M.body_sub[b];
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < MK_NBODY; d++)
        if (sub >> d & 1) s += K.fown[d][k];
      K.fsub[b][k] = s;
    }
    cx.sync();

    // ---- bias, damping and servo forces on each dof
    for (int v = lane; v < MK_NV; v += NL) {
      const float* f = K.fsub[M.dof_body[v]];
      float bias = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; k++) bias += S.cdof[v][k] * f[k];
      float q = -M.dof_damping[v] * S.qvel[v] - bias;
      for (int u = 0; u < MK_NU; u++)
        if (M.act_dadr[u] == v) q += S.force[u];
      S.qfrc[v] = q;
      S.qacc_smooth[v] = q;
    }
    cx.sync();  // the kinematic scratch K is dead from here on

    // ---- unconstrained acceleration
    chol_ba(M, cx, S.H, S.rinv);
    solve_ba(M, cx, S.H, S.rinv, S.qacc_smooth);

    // ---- contacts: every hull vertex against the floor, one per lane-iteration
    for (int f = lane; f < MK_NFOOT + 1; f += NL) {
      float t[3];
      if (f < MK_NFOOT) {
        const int b = M.foot_body[f];
        float q[4];
        quat_rot(S.xquat[b], M.foot_gpos[f], t);
        quat_mul(S.xquat[b], M.foot_gquat[f], q);
#pragma unroll
        for (int k = 0; k < 3; k++) R.fgpos[f][k] = S.xpos[b][k] + t[k];
#pragma unroll
        for (int k = 0; k < 4; k++) R.fgquat[f][k] = q[k];
      } else {
        const int fb = M.floor_body;
        quat_rot(S.xquat[fb], M.floor_gpos, t);
#pragma unroll
        for (int k = 0; k < 3; k++) R.fpos[k] = S.xpos[fb][k] + t[k];
#if !MK_HFIELD
        const float ez[3] = {0.0f, 0.0f, 1.0f};
        float fquat[4], n[3], u1[3], u2[3];
        quat_mul(S.xquat[fb], M.floor_gquat, fquat);
        quat_rot(fquat, ez, n);
        tangent_frame(n, u1, u2);
#pragma unroll
        for (int k = 0; k < 3; k++) {
          R.normal[0][k] = n[k];
          R.t1[0][k] = u1[k];
          R.t2[0][k] = u2[k];
        }
#endif
      }
    }
    cx.sync();
    for (int it = lane; it < MK_NFOOT * MK_NVERT; it += NL) {
      const int f = it / MK_NVERT, v = it % MK_NVERT;
      float t[3], p[3];
      quat_rot(R.fgquat[f], M.foot_hull[f][v], t);
#pragma unroll
      for (int k = 0; k < 3; k++) {
        p[k] = R.fgpos[f][k] + t[k];
        R.vert[it][k] = p[k];
      }
#if MK_HFIELD
      // height above the triangle under the vertex, onto its normal
      float nv[3];
      float h = hfield_height_normal(M, a.hfield, p[0] - R.fpos[0], p[1] - R.fpos[1], nv);
      R.vd[it] = ((p[2] - R.fpos[2]) - h) * nv[2];
#else
      float rel[3] = {p[0] - R.fpos[0], p[1] - R.fpos[1], p[2] - R.fpos[2]};
      R.vd[it] = dot3(rel, R.normal[0]);
#endif
    }
    cx.sync();
    // the KPTS deepest vertices of each foot: KPTS rounds of an arg-min
    for (int f = 0; f < MK_NFOOT; f++) {
      unsigned int used = 0u;
      for (int s = 0; s < MK_KPTS; s++) {
        int best = -1;
        float dbest = 0.0f;
        for (int v = lane; v < MK_NVERT; v += NL) {
          if (used & (1u << v)) continue;
          const float d = R.vd[f * MK_NVERT + v];
          if (best < 0 || d < dbest) {
            best = v;
            dbest = d;
          }
        }
        best = cx.argmin(dbest, best);
        used |= 1u << best;
        if (lane == 0) R.cvert[f * MK_KPTS + s] = f * MK_NVERT + best;
      }
    }
    cx.sync();
    for (int c = lane; c < MK_NCON; c += NL) {
      const int vi = R.cvert[c];
      const float d = R.vd[vi];
      S.con_dist[c] = d;
#if MK_HFIELD
      // the chosen vertex's normal again, rather than one kept per vertex
      float n[3], u1[3], u2[3];
      hfield_height_normal(M, a.hfield, R.vert[vi][0] - R.fpos[0], R.vert[vi][1] - R.fpos[1], n);
      tangent_frame(n, u1, u2);
#pragma unroll
      for (int k = 0; k < 3; k++) {
        R.normal[c][k] = n[k];
        R.t1[c][k] = u1[k];
        R.t2[c][k] = u2[k];
      }
#else
      const float* n = R.normal[0];
#endif
#pragma unroll
      for (int k = 0; k < 3; k++) R.con_pos[c][k] = R.vert[vi][k] - 0.5f * d * n[k];
    }
    cx.sync();

    // ---- contact base rows on their support: one column of one contact
    // per lane-iteration
    for (int it = lane; it < MK_NCON * MK_NSUP; it += NL) {
      const int c = it / MK_NSUP, s = it % MK_NSUP, f = c / MK_KPTS;
      const int v = sup_dof(M, f, s);
      float jn = 0.0f, j1 = 0.0f, j2 = 0.0f;
      if (v >= 0 && S.con_dist[c] < 0.0f && (M.body_dofs[M.foot_body[f]] & (1u << v))) {
        float rel[3], jp[3];
#pragma unroll
        for (int k = 0; k < 3; k++) rel[k] = R.con_pos[c][k] - com[k];
        cross3(S.cdof[v], rel, jp);
#pragma unroll
        for (int k = 0; k < 3; k++) jp[k] += S.cdof[v][3 + k];
        jn = dot3(R.normal[MK_CI(c)], jp);
        j1 = dot3(R.t1[MK_CI(c)], jp);
        j2 = dot3(R.t2[MK_CI(c)], jp);
      }
      R.Jc[c][0][s] = jn;
      R.Jc[c][1][s] = j1;
      R.Jc[c][2][s] = j2;
    }
    for (int c = lane; c < MK_NCON; c += NL) {
      const int on = S.con_dist[c] < 0.0f;
#pragma unroll
      for (int fc = 0; fc < 4; fc++) R.active[MK_NROW1 + 4 * c + fc] = on;
    }
    cx.sync();
    contact_base(M, cx, R, S.qvel);
    cx.sync();

    // ---- constraint rows: one row (or one contact's four) per lane-iteration
    for (int it = lane; it < MK_NROW1 + MK_NCON; it += NL) {
      if (it < MK_NFRIC) {
        const int i = it, dof = M.fric_dof[i];
        R.rdof[i] = dof;
        R.rsign[i] = 1.0f;
        R.aref[i] = -M.fric_b[i] * S.qvel[dof];
        R.R[i] = M.fric_R[i];
        R.D[i] = 1.0f / M.fric_R[i];
        R.fl[i] = S.fl[dof];
        R.active[i] = 1;
      } else if (it < MK_NROW1) {
        const int i = it, l = it - MK_NFRIC, dof = M.lim_dadr[l];
        float q = S.qpos[M.lim_qadr[l]];
        float dlo = q - M.lim_range[l][0], dhi = M.lim_range[l][1] - q;
        float sign = dlo < dhi ? 1.0f : -1.0f;
        float dist = dlo < dhi ? dlo : dhi;
        float pos = dist - M.lim_margin[l];
        float imp = impedance(M.lim_solimp[l], pos);
        const int on = dist < M.lim_margin[l];
        float Rl = mk_max((1 - imp) / imp * M.lim_invw[l], MK_MINVAL);
        R.rdof[i] = dof;
        R.rsign[i] = sign;
        R.R[i] = Rl;
        R.fl[i] = 0.0f;
        R.active[i] = on;
        R.aref[i] = on ? -M.lim_b[l] * sign * S.qvel[dof] - M.lim_k[l] * imp * pos : 0.0f;
        R.D[i] = on ? 1.0f / Rl : 0.0f;
      } else {
        const int c = it - MK_NROW1, f = c / MK_KPTS;
        const float dist = S.con_dist[c];
        const bool on = dist < 0.0f;
        float imp = impedance(M.con_solimp, dist);
        float mu2 = mu * mu;
        float diag = 2.0f * mu2 * (1.0f + mu2) * M.foot_invw[f];
        float Rc = mk_max((1 - imp) / imp * diag, MK_MINVAL);
#pragma unroll
        for (int fc = 0; fc < 4; fc++) {
          const int i = MK_NROW1 + 4 * c + fc;
          float vel = R.cb[c][0] + ((fc & 1) ? -mu : mu) * R.cb[c][1 + (fc >> 1)];
          R.R[i] = Rc;
          R.fl[i] = 0.0f;
          R.aref[i] = on ? -M.con_b * vel - M.con_k * imp * dist : 0.0f;
          R.D[i] = on ? 1.0f / Rc : 0.0f;
        }
      }
    }
    cx.sync();

    // ---- Newton solve from the better of warmstart and qacc_smooth
    {
      for (int v = lane; v < MK_NV; v += NL) S.xa[v] = S.warm[v] - S.qacc_smooth[v];
      cx.sync();
      symv_ba(M, cx, S.Mq, S.xa, S.Mxa);
      rows_jx(M, cx, R, mu, S.warm, R.jar);  // syncs: Mxa is visible too
      float quad = 0.0f;
      for (int v = lane; v < MK_NV; v += NL) quad += S.xa[v] * S.Mxa[v];
      const float c_w = 0.5f * cx.sum(quad) + rows_cost(cx, R, R.jar);
      rows_jx(M, cx, R, mu, S.qacc_smooth, R.jv);
      const float c_s = rows_cost(cx, R, R.jv);
      for (int v = lane; v < MK_NV; v += NL) S.qacc[v] = c_w < c_s ? S.warm[v] : S.qacc_smooth[v];
      cx.sync();
    }
    for (int it_n = 0; it_n < M.iterations; it_n++) {
      for (int v = lane; v < MK_NV; v += NL) S.xa[v] = S.qacc[v] - S.qacc_smooth[v];
      for (int it = lane; it < MK_NBA; it += NL) S.H[it] = S.Mq[it];
      cx.sync();
      symv_ba(M, cx, S.Mq, S.xa, S.Mxa);
      rows_jx(M, cx, R, mu, S.qacc, R.jar);
      for (int i = lane; i < MK_NEFC; i += NL) {
        float g = 0.0f, h = 0.0f, jar = 0.0f;
        if (R.active[i]) {
          jar = R.jar[i] - R.aref[i];
          row_gh(R, i, jar, &g, &h);
        }
        R.jar[i] = jar;
        R.g[i] = g;
        R.h[i] = h;
      }
      cx.sync();
      // the four facets of a contact folded onto its base rows: J^T g and
      // J^T diag(h) J need only G (3) and the symmetric W (3x3, t1t2 = 0)
      for (int c = lane; c < MK_NCON; c += NL) {
        const float* g = &R.g[MK_NROW1 + 4 * c];
        const float* h = &R.h[MK_NROW1 + 4 * c];
        R.G[c][0] = (g[0] + g[1]) + (g[2] + g[3]);
        R.G[c][1] = mu * (g[0] - g[1]);
        R.G[c][2] = mu * (g[2] - g[3]);
        R.W[c][0] = (h[0] + h[1]) + (h[2] + h[3]);
        R.W[c][1] = mu * (h[0] - h[1]);
        R.W[c][2] = mu * (h[2] - h[3]);
        R.W[c][3] = mu * mu * (h[0] + h[1]);
        R.W[c][4] = mu * mu * (h[2] + h[3]);
        R.W[c][5] = (h[0] != 0.0f || h[1] != 0.0f || h[2] != 0.0f || h[3] != 0.0f) ? 1.0f : 0.0f;
      }
      cx.sync();
      // gradient and the Hessian's diagonal rows: one dof per lane-iteration
      for (int v = lane; v < MK_NV; v += NL) {
        float gv = S.Mxa[v], hv = 0.0f;
        const int fr = M.dof_fric[v], lm = M.dof_lim[v];
        if (fr >= 0) {
          gv += R.rsign[fr] * R.g[fr];
          hv += R.h[fr];
        }
        if (lm >= 0) {
          gv += R.rsign[MK_NFRIC + lm] * R.g[MK_NFRIC + lm];
          hv += R.h[MK_NFRIC + lm];
        }
        for (int f = 0; f < MK_NFOOT; f++) {
          const int s = sup_col(M, f, v);
          if (s < 0) continue;
          for (int c = f * MK_KPTS; c < (f + 1) * MK_KPTS; c++)
            if (R.active[MK_NROW1 + 4 * c])
              gv += R.Jc[c][0][s] * R.G[c][0] + R.Jc[c][1][s] * R.G[c][1] + R.Jc[c][2][s] * R.G[c][2];
        }
        S.grad[v] = gv;
        S.H[ba_idx(M, v, v)] += hv;
      }
      cx.sync();
      // contact curvature: one entry of the foot's support triangle per
      // lane-iteration, foot after foot (both reach the root block)
      for (int f = 0; f < MK_NFOOT; f++) {
        for (int it = lane; it < MK_NSUPTRI; it += NL) {
          const int s = M.sup_ij[it] & 255, t = M.sup_ij[it] >> 8;
          const int vs = sup_dof(M, f, s), vt = sup_dof(M, f, t);
          if (vs < 0 || vt < 0) continue;
          float acc = 0.0f;
          for (int c = f * MK_KPTS; c < (f + 1) * MK_KPTS; c++) {
            if (R.W[c][5] == 0.0f) continue;
            const float* W = R.W[c];
            const float an = R.Jc[c][0][t], a1 = R.Jc[c][1][t], a2 = R.Jc[c][2][t];
            acc += R.Jc[c][0][s] * (W[0] * an + W[1] * a1 + W[2] * a2) +
                   R.Jc[c][1][s] * (W[1] * an + W[3] * a1) + R.Jc[c][2][s] * (W[2] * an + W[4] * a2);
          }
          S.H[ba_idx(M, vs, vt)] += acc;
        }
        cx.sync();
      }
      chol_ba(M, cx, S.H, S.rinv);
      for (int v = lane; v < MK_NV; v += NL) S.dx[v] = S.grad[v];
      cx.sync();
      solve_ba(M, cx, S.H, S.rinv, S.dx);
      for (int v = lane; v < MK_NV; v += NL) S.dx[v] = -S.dx[v];
      cx.sync();

      symv_ba(M, cx, S.Mq, S.dx, S.mv);
      rows_jx(M, cx, R, mu, S.dx, R.jv);
      float g0 = 0.0f, hq = 0.0f;
      for (int v = lane; v < MK_NV; v += NL) {
        g0 += S.dx[v] * S.Mxa[v];
        hq += S.dx[v] * S.mv[v];
      }
      g0 = cx.sum(g0);
      hq = cx.sum(hq);
      float alpha = 0.0f;
      for (int ls = 0; ls < M.ls_iterations; ls++) {
        float dphi = 0.0f, ddphi = 0.0f;
        for (int i = lane; i < MK_NEFC; i += NL) {
          if (!R.active[i]) continue;
          float gi, hi;
          const float jv = R.jv[i];
          row_gh(R, i, R.jar[i] + alpha * jv, &gi, &hi);
          dphi += jv * gi;
          ddphi += hi * jv * jv;
        }
        dphi = g0 + alpha * hq + cx.sum(dphi);
        ddphi = hq + cx.sum(ddphi);
        alpha = alpha - dphi / mk_max(ddphi, 1e-12f);
      }
      for (int v = lane; v < MK_NV; v += NL) S.qacc[v] = S.qacc[v] + alpha * S.dx[v];
      cx.sync();
    }

    // ---- last substep: site poses and sensors from the start of the
    // substep, staged for the store (the rows are dead by now)
    if (last) {
      MkStage& O = S.u.o;
      for (int s = lane; s < MK_NSITE; s += NL) {
        const int b = M.site_body[s];
        float t[3], q[4], R9[9];
        quat_rot(S.xquat[b], M.site_pos[s], t);
        quat_mul(S.xquat[b], M.site_quat[s], q);
        quat_mat(q, R9);
#pragma unroll
        for (int k = 0; k < 3; k++) O.sxp[s][k] = S.xpos[b][k] + t[k];
#pragma unroll
        for (int k = 0; k < 9; k++) O.sxm[s][k] = R9[k];
      }
      cx.sync();
      for (int si = lane; si < MK_NSENSOR; si += NL) {
        const int s = M.sensor_obj[si], b = M.site_body[s], adr = M.sensor_adr[si];
        const int kind = M.sensor_kind[si];
        const float* p = O.sxp[s];
        const float* R9 = O.sxm[s];
        float* sd = &O.sens[adr];
        float rel[3], wr[3], vp[3], w[3];
#pragma unroll
        for (int k = 0; k < 3; k++) {
          rel[k] = p[k] - com[k];
          w[k] = S.cvel[b][k];
        }
        cross3(w, rel, wr);
#pragma unroll
        for (int k = 0; k < 3; k++) vp[k] = S.cvel[b][3 + k] + wr[k];
        if (kind == MK_GYRO || kind == MK_VELOCIMETER || kind == MK_ACCELEROMETER) {
          float vec[3];
          if (kind == MK_GYRO) {
#pragma unroll
            for (int k = 0; k < 3; k++) vec[k] = w[k];
          } else if (kind == MK_VELOCIMETER) {
#pragma unroll
            for (int k = 0; k < 3; k++) vec[k] = vp[k];
          } else {
            // body acceleration after the solve (mj_rnePostConstraint)
            float cacc[6] = {0.0f, 0.0f, 0.0f, -M.gravity[0], -M.gravity[1], -M.gravity[2]};
            for (unsigned int m = M.body_dofs[b]; m; m &= m - 1) {
              const int v = mk_ctz(m);
              const float qv = S.qvel[v], qa = S.qacc[v];
#pragma unroll
              for (int k = 0; k < 6; k++) cacc[k] += S.cdof_dot[v][k] * qv + S.cdof[v][k] * qa;
            }
            float x1[3], x2[3];
            cross3(cacc, rel, x1);
            cross3(w, vp, x2);
#pragma unroll
            for (int k = 0; k < 3; k++) vec[k] = cacc[3 + k] + x1[k] + x2[k];
          }
#pragma unroll
          for (int k = 0; k < 3; k++) sd[k] = R9[k] * vec[0] + R9[3 + k] * vec[1] + R9[6 + k] * vec[2];
        } else if (kind == MK_FRAMEZAXIS) {
#pragma unroll
          for (int k = 0; k < 3; k++) sd[k] = R9[3 * k + 2];
        } else if (kind == MK_FRAMEXAXIS) {
#pragma unroll
          for (int k = 0; k < 3; k++) sd[k] = R9[3 * k];
        } else if (kind == MK_FRAMELINVEL) {
#pragma unroll
          for (int k = 0; k < 3; k++) sd[k] = vp[k];
        } else if (kind == MK_FRAMEANGVEL) {
#pragma unroll
          for (int k = 0; k < 3; k++) sd[k] = w[k];
        } else if (kind == MK_FRAMEPOS) {
#pragma unroll
          for (int k = 0; k < 3; k++) sd[k] = p[k];
        } else if (kind == MK_FRAMEQUAT) {
          float q[4];
          quat_mul(S.xquat[b], M.site_quat[s], q);
#pragma unroll
          for (int k = 0; k < 4; k++) sd[k] = q[k];
        }
      }
      cx.sync();
    }

    // ---- semi-implicit Euler: velocities, then one joint per lane-iteration
    for (int v = lane; v < MK_NV; v += NL) {
      S.qvel[v] = S.qvel[v] + dt * S.qacc[v];
      S.warm[v] = S.qacc[v];
    }
    cx.sync();
    for (int j = lane; j < MK_NJNT; j += NL) {
      const int qa = M.jnt_qposadr[j], da = M.jnt_dofadr[j];
      if (M.jnt_type[j] == MK_HINGE) {
        S.qpos[qa] = S.qpos[qa] + dt * S.qvel[da];
        continue;
      }
#pragma unroll
      for (int k = 0; k < 3; k++) S.qpos[qa + k] = S.qpos[qa + k] + dt * S.qvel[da + k];
      const float* om = &S.qvel[da + 3];
      float angle = sqrtf(om[0] * om[0] + om[1] * om[1] + om[2] * om[2]);
      float dq[4] = {1.0f, 0.0f, 0.0f, 0.0f};
      if (!(angle < 1e-12f)) {
        float axis[3] = {om[0] / angle, om[1] / angle, om[2] / angle};
        axis_angle_quat(axis, angle * dt, dq);
      }
      float q0[4] = {S.qpos[qa + 3], S.qpos[qa + 4], S.qpos[qa + 5], S.qpos[qa + 6]}, qn[4];
      quat_mul(q0, dq, qn);
      float nrm = sqrtf(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2] + qn[3] * qn[3]);
#pragma unroll
      for (int k = 0; k < 4; k++) S.qpos[qa + 3 + k] = qn[k] / nrm;
    }
    cx.sync();
  }

  // ---- store: consecutive lanes on consecutive addresses
  const MkStage& O = S.u.o;
  for (int i = lane; i < MK_NQ; i += NL) a.o_qpos[eo * MK_NQ + i] = S.qpos[i];
  for (int i = lane; i < MK_NV; i += NL) {
    a.o_qvel[eo * MK_NV + i] = S.qvel[i];
    a.o_qacc[eo * MK_NV + i] = S.qacc[i];
    a.o_warm[eo * MK_NV + i] = S.qacc[i];
  }
  for (int i = lane; i < MK_NSITE * 3; i += NL) a.o_site_xpos[eo * MK_NSITE * 3 + i] = (&O.sxp[0][0])[i];
  for (int i = lane; i < MK_NSITE * 9; i += NL) a.o_site_xmat[eo * MK_NSITE * 9 + i] = (&O.sxm[0][0])[i];
  for (int i = lane; i < MK_NU; i += NL) a.o_actuator_force[eo * MK_NU + i] = S.force[i];
  for (int i = lane; i < MK_NCON; i += NL) a.o_contact_dist[eo * MK_NCON + i] = S.con_dist[i];
  for (int i = lane; i < MK_NSENSDATA; i += NL) a.o_sensordata[eo * MK_NSENSDATA + i] = O.sens[i];
}
