"""Static structural index sets derived from a ModelSpec (numpy, host side).

Counterpart of `open_duck_playground_tpu/physics/structure.py`: the engine
gathers with these precomputed index arrays instead of walking the tree per
body. `dof_chain_blocks` (the block-arrow partition) and `tree_levels` also
shape the CUDA kernel's tables (`megakernel.partition`, `model_tables`).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

from benchmark.reference.physics.types import FREE, HINGE, ModelSpec


@functools.lru_cache(maxsize=16)
def tree_levels(spec: ModelSpec) -> Tuple[Tuple[int, ...], ...]:
    """Bodies grouped by tree depth (world excluded); parents always sit in
    an earlier level."""
    depth = [0] * spec.nbody
    for b in range(1, spec.nbody):
        depth[b] = depth[spec.body_parentid[b]] + 1
    levels: List[List[int]] = [[] for _ in range(max(depth) + 1)]
    for b in range(1, spec.nbody):
        levels[depth[b]].append(b)
    return tuple(tuple(l) for l in levels if l)


@functools.lru_cache(maxsize=16)
def dof_pred_mask(spec: ModelSpec) -> np.ndarray:
    """pred[d, e] = 1 iff dof e contributes to the carrier velocity seen when
    processing dof d in mj_comVel order: e on a strict ancestor body, or on
    the same body with e < d. A free joint's three rotational dofs share one
    carrier (mj_comVel computes their cdof_dot before adding rotation)."""
    nv = spec.nv
    anc = [set() for _ in range(spec.nbody)]
    for b in range(1, spec.nbody):
        p = spec.body_parentid[b]
        anc[b] = anc[p] | {p}
    pred = np.zeros((nv, nv), dtype=np.float64)
    for d in range(nv):
        bd = spec.dof_bodyid[d]
        for e in range(nv):
            be = spec.dof_bodyid[e]
            if be in anc[bd] or (be == bd and e < d):
                pred[d, e] = 1.0
    for j in range(spec.njnt):
        if spec.jnt_type[j] == FREE:
            a = spec.jnt_dofadr[j]
            pred[a + 3 : a + 6, a + 3 : a + 6] = 0.0
    return pred


@functools.lru_cache(maxsize=16)
def free_trans_mask(spec: ModelSpec) -> np.ndarray:
    """0 for free-joint translational dofs (their cdof_dot is 0 in
    mj_comVel), 1 elsewhere."""
    m = np.ones(spec.nv)
    for j in range(spec.njnt):
        if spec.jnt_type[j] == FREE:
            d = spec.jnt_dofadr[j]
            m[d : d + 3] = 0.0
    return m


@functools.lru_cache(maxsize=16)
def hinge_joints(spec: ModelSpec) -> np.ndarray:
    return np.array(
        [j for j in range(spec.njnt) if spec.jnt_type[j] == HINGE], dtype=np.int32
    )


@functools.lru_cache(maxsize=16)
def free_joint(spec: ModelSpec) -> int:
    for j in range(spec.njnt):
        if spec.jnt_type[j] == FREE:
            return j
    return -1


@functools.lru_cache(maxsize=16)
def limited_hinges(spec: ModelSpec) -> np.ndarray:
    return np.array(
        [
            j
            for j in range(spec.njnt)
            if spec.jnt_type[j] == HINGE and spec.jnt_limited[j]
        ],
        dtype=np.int32,
    )


@functools.lru_cache(maxsize=16)
def one_hot_dofs(spec: ModelSpec, dofs: Tuple[int, ...]) -> np.ndarray:
    e = np.zeros((len(dofs), spec.nv))
    for i, d in enumerate(dofs):
        e[i, d] = 1.0
    return e


@functools.lru_cache(maxsize=16)
def dof_chain_blocks(spec: ModelSpec):
    """Block-arrow partition of the dof index space, if the model has one.

    Returns ``(root_block, chain_blocks)``: the half-open dof range of the
    root free joint and one half-open dof range per serial kinematic chain
    hanging off the root. Returns ``None`` when the model has no root free
    joint at dof 0, has branching chains or non-contiguous dof numbering.
    """
    nv, nbody = spec.nv, spec.nbody
    fj = free_joint(spec)
    if fj < 0 or spec.jnt_dofadr[fj] != 0:
        return None
    root = (0, 6)
    root_body = int(spec.jnt_bodyid[fj])

    parent = [int(p) for p in spec.body_parentid]
    anc_bodies = []
    for b in range(nbody):
        chain = []
        w = b
        while w != 0:
            chain.append(w)
            w = parent[w]
        anc_bodies.append(set(chain))

    dof_body = [int(b) for b in spec.dof_bodyid]
    hinge_dofs = [d for d in range(nv) if dof_body[d] != root_body or d >= 6]
    if sorted(hinge_dofs) != list(range(6, nv)):
        return None

    children = [[] for _ in range(nbody)]
    for b in range(1, nbody):
        children[parent[b]].append(b)

    def subtree_bodies(b):
        out = [b]
        for c in children[b]:
            out.extend(subtree_bodies(c))
        return out

    chains = []
    stack = list(children[root_body])
    chain_roots = []
    while stack:
        b = stack.pop()
        if spec.body_jntnum[b] > 0:
            chain_roots.append(b)
        else:
            stack.extend(children[b])
    for cb in sorted(chain_roots):
        bodies = subtree_bodies(cb)
        dofs = sorted(d for d in range(6, nv) if dof_body[d] in bodies)
        if not dofs:
            continue
        if dofs != list(range(dofs[0], dofs[-1] + 1)):
            return None
        for d in dofs:
            for e in dofs:
                bd, be = dof_body[d], dof_body[e]
                if bd != be and bd not in anc_bodies[be] and be not in anc_bodies[bd]:
                    return None
        chains.append((dofs[0], dofs[-1] + 1))
    covered = sorted(chains)
    pos = 6
    for a, b in covered:
        if a != pos:
            return None
        pos = b
    if pos != nv:
        return None
    return root, tuple(covered)
