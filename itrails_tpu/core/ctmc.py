"""Jitted executor for the interval-DP :class:`~itrails_tpu.core.schedule.Plan`.

Given model rates, computes the joint probability matrix over pairs of HMM
hidden states (left locus tree, right locus tree).  The whole computation is
a fixed sequence (unrolled over the static interval count) of batched masked
matmuls, one batched ``expm`` per chain, batched Van Loan block exponentials
(grouped + deduplicated by omega-path), and a block-bidiagonal-inverse chain
for the final t->inf integrals:

    reference pipeline                         here
    ------------------------------------       --------------------------------
    expm per interval (expm.py)                one expm_batch per chain
    per-path dict fan-out + joblib matmuls     gather -> mask -> (K,S)@(S,S)
      (run_markov_chain_{AB,ABC}.py)             -> mask -> scatter
    vanloan() block expm per subpath           expm_batch per (step, length)
      (vanloan.py:392-425)                       over unique omega paths
    deepest_ti() inverse of (201*m)^2 block    N = (-Q)^{-1} once + masked
      (deepest_ti.py:215-256)                    matmul chains (block-
                                                 bidiagonal inverse identity)
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from itrails_tpu.core.expm import expm_batch
from itrails_tpu.core.schedule import Plan
from itrails_tpu.core.statespace import combine_partitions_map, state_space

__all__ = ["joint_matrix"]


def _rate_matrix(space, coal, rho, dtype):
    q = coal * jnp.asarray(space.coal_pattern, dtype) + rho * jnp.asarray(
        space.rho_pattern, dtype
    )
    return q - jnp.diag(jnp.sum(q, axis=1))


# finer steps around 64-96: at 7x7 the 73-88-state supports are 90% of
# the Van Loan expm flops, and padding them to 96 cost an extra ~2 Gflop
_BUCKET_SIZES = (8, 16, 24, 32, 40, 48, 56, 64, 72, 80, 88, 96, 104, 112,
                 128, 160, 208)


def _vl_buckets(step, masks_np):
    """Static (trace-time) grouping of a step's union propagators by padded
    support size.

    The union-restricted generator diag(u) Q diag(u) is zero outside the
    union's state support, so its exponential is block-diagonal: the
    restriction to the support (expm of an |support|^2 submatrix — at most
    83 of 203 states, usually far fewer) plus identity elsewhere.  The
    identity part never contributes (start/end class masks lie inside the
    support), so each propagator shrinks to its support block.
    """
    supports = [np.where(m > 0.0)[0] for m in masks_np[step.vl_unions]]
    buckets = {}
    for ui, sup in enumerate(supports):
        size = next(b for b in _BUCKET_SIZES if b >= len(sup))
        buckets.setdefault(size, []).append(ui)
    out = []
    prop = step.vl_prop
    for size, uis in sorted(buckets.items()):
        sup_idx = np.full((len(uis), size), masks_np.shape[1], dtype=np.int64)
        local = np.full(len(supports), -1, dtype=np.int64)
        for k, ui in enumerate(uis):
            sup_idx[k, : len(supports[ui])] = supports[ui]
            local[ui] = k
        t_sel = np.where(local[prop] >= 0)[0]
        out.append((sup_idx, t_sel, local[prop[t_sel]]))
    return out


def _space_autoperms(n: int):
    """Automorphism permutations of the ``n``-state space (species
    relabelings), or just the identity when ``n`` matches no full space.

    Every returned non-identity perm is verified to preserve the space's
    coal/rho rate patterns exactly (integer 0/1 pattern equality), so any
    generator of the form ``coal * coal_pattern + rho * rho_pattern``
    (ctmc._rate_matrix, introgression.model._rate — one SCALAR rate per
    class) is provably invariant under it: the orbit dedup in
    _precompute_vl can reuse one representative exponential per orbit.
    A future variant with per-population rates inside one epoch would
    break that invariance *without* changing the patterns — such a
    variant must not route its generator through the scalar-rate
    constructors (ADVICE r4: this was previously assumed, not checked)."""
    from itrails_tpu.core.statespace import automorphism_perms

    for species in (3, 2):
        space = state_space(species)
        if space.n_states == n:
            perms = automorphism_perms(species)
            ident = np.arange(n, dtype=np.int64)
            kept = []
            for p in perms:
                if np.array_equal(p, ident) or all(
                    np.array_equal(pat[np.ix_(p, p)], pat)
                    for pat in (np.asarray(space.coal_pattern),
                                np.asarray(space.rho_pattern))
                ):
                    kept.append(p)
            return tuple(kept)
    return (np.arange(n, dtype=np.int64),)


def _group_apps(t_sel, local_prop, n_unions):
    """Static grouping of a bucket's propagator applications by union.

    The naive ``einsum("vs,vst->vt", y_sub, e_sub[local_prop])`` streams a
    (n_apps, S, S) gathered propagator tensor — ~650 MB at 7x7, the
    dominant chain cost.  Grouping the applications per union (padded to
    power-of-two class sizes, <=2x row padding) turns it into per-class
    (Ug, K, S) @ (Ug, S, S) batched matmuls that read each propagator
    once.  Returns (classes, inv_pos): classes = [(union_ids (Ug,),
    app_idx (Ug, K) padded with -1)], inv_pos (n_apps,) mapping each
    application to its row in the concatenated class outputs."""
    order = np.argsort(local_prop, kind="stable")
    counts = np.bincount(local_prop, minlength=n_unions)
    classes = {}
    start = 0
    for u in range(n_unions):
        apps = order[start:start + counts[u]]
        start += counts[u]
        if counts[u] == 0:
            continue
        k = 1 << (int(counts[u]) - 1).bit_length()
        classes.setdefault(k, []).append((u, apps))
    cl_out = []
    inv_pos = np.empty(local_prop.size, dtype=np.int64)
    flat = 0
    for k in sorted(classes):
        uids = np.array([u for u, _ in classes[k]], dtype=np.int64)
        app_idx = np.full((len(uids), k), -1, dtype=np.int64)
        for i, (u, apps) in enumerate(classes[k]):
            app_idx[i, : apps.size] = apps
            inv_pos[apps] = flat + i * k + np.arange(apps.size)
        flat += len(uids) * k
        cl_out.append((uids, app_idx))
    return cl_out, inv_pos


def _precompute_vl(plan_steps, masks_np, q, dt):
    """Bucket structures + propagator exponentials for every Van Loan step,
    batched across ALL steps: one ``expm_batch`` per support-size class
    instead of one per (step, bucket).  At 7x7 the six ABC steps carry
    ~10k propagator applications over ~a thousand unique union supports;
    batching them collapses dozens of small expm dispatches (the dominant
    cached-build cost) into a handful of large ones.

    Orbit dedup: the per-epoch rates are species-symmetric, so supports
    related by a species relabeling have permutation-identical restricted
    generators (statespace.automorphism_perms) — ``expm(P^T A P) ==
    P^T expm(A) P``.  Each support is canonicalised under the group and
    only one representative per (step, orbit) is exponentiated; the job's
    gather/scatter index row is reordered into representative order so the
    representative's exponential applies directly.  At 7x7 this cuts the
    expm batch 525 -> 151 (the >=56-state buckets, 90% of the flops,
    198 -> 48).  Exactness: identical up to the ~1-ulp row-sum rounding
    of the permuted diagonal (goldens pin at 1e-9 relative)."""
    n = masks_np.shape[1]
    # Dedup precondition: q must be invariant under every returned perm.
    # _space_autoperms guarantees this structurally for any generator of
    # the form ``sum_i scalar_i * pattern_i`` over the space's rate
    # patterns (q is a tracer here, so it cannot be inspected directly).
    perms = _space_autoperms(n)
    q_ext = jnp.pad(q, ((0, 1), (0, 1)))  # zero padding row/col
    per_step = []
    by_size = {}
    for s, step in enumerate(plan_steps):
        buckets = _vl_buckets(step, masks_np) if step.vl_parent.size else []
        per_step.append(buckets)
        for bi, (sup_idx, _, _) in enumerate(buckets):
            by_size.setdefault(sup_idx.shape[1], []).append((s, bi, sup_idx))
    expms = {}
    for size, jobs in sorted(by_size.items()):
        uniq = {}  # (step, canonical support bytes) -> unique row id
        rep_sup, rep_step = [], []  # padded support row / step per unique id
        job_src = []  # (s, bi, per-union unique row ids)
        for s, bi, sup_idx in jobs:
            rid = np.empty(sup_idx.shape[0], dtype=np.int64)
            new_sup = sup_idx.copy()
            for k, row in enumerate(sup_idx):
                real = row[row < n]
                best = None
                for p in perms:
                    mapped = p[real]
                    order = np.argsort(mapped)
                    key = mapped[order].tobytes()
                    if best is None or key < best[0]:
                        best = (key, mapped[order], order)
                key, canon, order = best
                uk = (s, key)
                if uk not in uniq:
                    uniq[uk] = len(rep_sup)
                    rep = np.full(size, n, dtype=np.int64)
                    rep[: canon.size] = canon
                    rep_sup.append(rep)
                    rep_step.append(s)
                rid[k] = uniq[uk]
                # reorder this union's index row into representative order:
                # position j of the representative is state canon[j] =
                # p[real[order[j]]], whose original state is real[order[j]]
                new_sup[k, : real.size] = real[order]
            job_src.append((s, bi, rid))
            t_sel, local_prop = per_step[s][bi][1], per_step[s][bi][2]
            per_step[s][bi] = (new_sup, t_sel, local_prop)
        rep_cat = np.stack(rep_sup, axis=0)
        q_sub = q_ext[rep_cat[:, :, None], rep_cat[:, None, :]]
        dts = jnp.stack([dt[s] for s in rep_step])
        e = expm_batch(q_sub * dts[:, None, None])
        for s, bi, rid in job_src:
            expms[(s, bi)] = e[jnp.asarray(rid)]
    return per_step, expms


def _run_chain(plan_steps, masks, p, expms, vl_ctx=None, masks_np=None):
    """Run the interval DP: ``p`` is the (n_keys, S) key-probability table."""
    if vl_ctx is not None:
        q, dt = vl_ctx
        vl_buckets, vl_expms = _precompute_vl(plan_steps, masks_np, q, dt)
    for s, step in enumerate(plan_steps):
        e = expms[s]
        new_p = p
        # normal transitions: (P[parent] * m_start) @ E * m_end.  Two
        # trace-time (static plan) reductions on the dominant matmul:
        # 1. children sharing (parent, m_start) — the start mask is a
        #    property of the parent key — share the row (28k -> 15.7k rows
        #    at 7x7);
        # 2. the row is zero outside the start class's support (masks are
        #    0/1), so the contraction slices to (rows, |supp|) @
        #    (|supp|, S) — mean support 31 of 203, cutting the flops ~67x.
        #    Dropping exact zeros from a dot product is bit-exact.
        pairs = np.stack([step.parent, step.m_start], axis=1)
        upairs, inv = np.unique(pairs, axis=0, return_inverse=True)
        if masks_np is not None:
            zs, order = [], []
            for c in np.unique(upairs[:, 1]):
                rows = np.where(upairs[:, 1] == c)[0]
                par = upairs[rows, 0]
                if c < 0:
                    zc = p[par] @ e
                else:
                    supp = np.where(masks_np[c] > 0)[0]
                    zc = p[par][:, supp] @ e[supp, :]
                zs.append(zc)
                order.append(rows)
            perm = np.concatenate(order)
            invperm = np.empty(upairs.shape[0], dtype=np.int64)
            invperm[perm] = np.arange(upairs.shape[0])
            z = jnp.concatenate(zs, axis=0)
            vals = z[invperm[inv]] * masks[step.m_end]
        else:
            x = p[upairs[:, 0]]
            ms = jnp.where(
                (upairs[:, 1] >= 0)[:, None],
                masks[np.maximum(upairs[:, 1], 0)],
                jnp.ones_like(x),
            )
            vals = ((x * ms) @ e)[inv] * masks[step.m_end]
        new_p = new_p.at[step.child].set(vals)
        if vl_ctx is not None and step.vl_parent.size:
            # multi-coalescence transitions via support-compressed
            # union-restricted propagators (see schedule.StepPlan docstring)
            n = q.shape[1]
            y = p[step.vl_parent] * masks[step.vl_m_start]
            # zero row (padded application slots) + zero col (padded
            # support slots, index n)
            y_pad = jnp.pad(y, ((0, 1), (0, 1)))
            n_v = step.vl_parent.size
            child_vals = jnp.zeros((n_v, n), p.dtype)
            for bi, (sup_idx, t_sel, local_prop) in enumerate(vl_buckets[s]):
                e_sub = vl_expms[(s, bi)]  # (Ub, S, S)
                # union-grouped application (see _group_apps): each
                # propagator is read once instead of once per application
                classes, inv_pos = _group_apps(t_sel, local_prop,
                                               sup_idx.shape[0])
                outs = []
                for union_ids, app_idx in classes:
                    glob = np.where(app_idx >= 0, t_sel[app_idx], n_v)
                    cols = sup_idx[union_ids]  # (Ug, S)
                    y_g = y_pad[glob[:, :, None], cols[:, None, :]]
                    outs.append(
                        jnp.einsum("uks,ust->ukt", y_g, e_sub[union_ids])
                        .reshape(-1, sup_idx.shape[1])
                    )
                out_sub = jnp.concatenate(outs, axis=0)[inv_pos]  # (Vb, S)
                rows = sup_idx[local_prop]  # (Vb, S)
                scat = (
                    jnp.zeros((len(t_sel), n + 1), p.dtype)
                    .at[jnp.arange(len(t_sel))[:, None], rows]
                    .add(out_sub)[:, :n]
                )
                child_vals = child_vals.at[t_sel].set(scat)
            cv = child_vals * masks[step.vl_m_end]
            new_p = new_p.at[step.vl_child].set(cv)
        p = new_p
    return p


def joint_matrix(
    plan: Plan,
    *,
    coal_A,
    coal_B,
    coal_C,
    coal_AB,
    coal_ABC,
    rho_A,
    rho_B,
    rho_C,
    rho_AB,
    rho_ABC,
    t_A,
    t_B,
    t_C,
    cut_AB,
    cut_ABC,
    dtype=jnp.float64,
):
    """Joint probability matrix over (left, right) hidden gene-tree states.

    ``cut_AB`` has ``n_int_AB + 1`` finite entries; ``cut_ABC`` has
    ``n_int_ABC + 1`` entries with the last one unused (infinity in the
    reference).  Returns a dense ``(M, M)`` matrix indexed by
    ``plan.hidden_states`` order; rows sum to the state's stationary mass
    (reference get_trans_emiss.py:159-168 consumes it the same way).
    """
    sp1 = state_space(1)
    sp2 = state_space(2)
    sp3 = state_space(3)

    q_a = _rate_matrix(sp1, coal_A, rho_A, dtype)
    q_b = _rate_matrix(sp1, coal_B, rho_B, dtype)
    q_c = _rate_matrix(sp1, coal_C, rho_C, dtype)
    q_ab = _rate_matrix(sp2, coal_AB, rho_AB, dtype)
    q_abc = _rate_matrix(sp3, coal_ABC, rho_ABC, dtype)

    cut_AB = jnp.asarray(cut_AB, dtype)
    cut_ABC = jnp.asarray(cut_ABC, dtype)
    dt_ab = cut_AB[1:] - cut_AB[:-1]  # (n_int_AB,)
    dt_abc = cut_ABC[1:] - cut_ABC[:-1]  # last entry unused (infinite interval)

    # single-sequence initial chains: start in the "left and right linked"
    # state (1,1) (reference get_joint_prob_mat.py:101-123)
    start_1 = sp1.index[(1, 1)]
    singles = expm_batch(
        jnp.stack([q_a * t_A, q_b * t_B, q_c * t_C])
    )[:, start_1, :]
    f_a, f_b, f_c = singles[0], singles[1], singles[2]

    combine2 = jnp.asarray(combine_partitions_map(1, 1), dtype)  # (15, 2, 2)
    combine3 = jnp.asarray(combine_partitions_map(2, 1), dtype)  # (203, 15, 2)

    pi_ab = jnp.einsum("i,j,mij->m", f_a, f_b, combine2)

    ab_masks = jnp.asarray(plan.ab_masks, dtype)
    abc_masks = jnp.asarray(plan.abc_masks, dtype)

    # ---- AB epoch ----
    e_ab = expm_batch(q_ab[None] * dt_ab[:, None, None])
    p_ab = jnp.zeros((plan.ab_n_keys, sp2.n_states), dtype)
    p_ab = p_ab.at[0].set(pi_ab)
    p_ab = _run_chain(plan.ab_steps, ab_masks, p_ab, e_ab,
                      masks_np=plan.ab_masks)

    # ---- combine with C, start ABC epoch ----
    pi_abc = jnp.einsum("ki,j,mij->km", p_ab, f_c, combine3)
    return run_abc_stage(plan, pi_abc, q_abc, cut_ABC, dtype)


def run_abc_stage(plan: Plan, pi_abc, q_abc, cut_ABC, dtype=jnp.float64):
    """Run the deep (ABC) epoch from per-initial-key probability vectors
    ``pi_abc`` of shape (len(plan.abc_init_from_ab), 203) to the joint
    hidden-state matrix.  Shared by the plain and introgression pipelines."""
    sp3 = state_space(3)
    abc_masks = jnp.asarray(plan.abc_masks, dtype)
    cut_ABC = jnp.asarray(cut_ABC, dtype)
    dt_abc = cut_ABC[1:] - cut_ABC[:-1]

    p_abc = jnp.zeros((plan.abc_n_keys, sp3.n_states), dtype)
    p_abc = p_abc.at[plan.abc_init_from_ab].set(pi_abc)

    n_steps = plan.n_int_ABC - 1
    if n_steps:
        e_abc = expm_batch(q_abc[None] * dt_abc[:n_steps, None, None])
        p_abc = _run_chain(
            plan.abc_steps, abc_masks, p_abc, e_abc, vl_ctx=(q_abc, dt_abc),
            masks_np=plan.abc_masks,
        )

    # ---- final (infinite) interval ----
    entries = jnp.zeros((plan.n_entries,), dtype)
    entries = entries.at[plan.direct_out].add(jnp.sum(p_abc[plan.direct_src], axis=1))

    keep = np.where(plan.keep_mask)[0]
    q_no = q_abc[jnp.ix_(keep, keep)]
    n_no = keep.size
    n_mat = jnp.linalg.solve(q_no, -jnp.eye(n_no, dtype=dtype))
    no_masks = jnp.asarray(plan.noabs_masks, dtype)
    p_no = p_abc[:, keep]

    for group in plan.deep_groups:
        x = p_no[group.src] @ n_mat
        for i in range(1, group.m):
            mf = no_masks[group.path[:, i - 1]]
            mt = no_masks[group.path[:, i]]
            x = ((x * mf) @ q_no) * mt
            if i < group.m - 1:
                x = x @ n_mat
        entries = entries.at[group.out].add(jnp.sum(x, axis=1))

    m = len(plan.hidden_states)
    joint = jnp.zeros((m, m), dtype)
    joint = joint.at[plan.entry_row, plan.entry_col].add(entries)
    return joint
