"""Emission probabilities for all hidden gene-tree states, as batched tensor
contractions (reference: get_emission_prob_mat.py).

Structure: for each hidden state the emission over observed 4-mers
``(a0, b0, c0, d0)`` is a Felsenstein-style contraction of

* JC69 branch propagators ``P(theta)`` with ``theta = sum_i mu_i t_i``
  (the JC69 propagator has the closed form ``1/4 + (I - 1/4) exp(-theta)``,
  exactly equal to the reference's numeric ``expm`` of the summed rate
  matrix, p_b_given_a at get_emission_prob_mat.py:22-44);
* a single-coalescence tensor ``F[a,b,c] = sum_d f(...)`` — the closed-form
  integral of the JC69 likelihood against a truncated-exponential
  coalescence density (JC69_analytical_integral, :47-92);
* a double-coalescence tensor ``D[a,b,c,d]`` for two coalescences in one
  interval (JC69_analytical_integral_double, :120-397).

The reference evaluates the contraction with 4^4 x 4^6 nested Python loops
per state (:586-606); here each state is one einsum and all states of a
geometry class are vmapped.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import vmap

__all__ = [
    "jc69_propagator",
    "coal_tensor_single",
    "coal_tensor_double",
    "emission_matrix",
]

# EQ[i, j] = 3/4 if i == j else -1/4  (the alpha/beta/... coefficients)
_EQ = np.full((4, 4), -0.25) + np.eye(4)

# Every alpha/beta/... coefficient is BINARY (-1/4 or 3/4), so the closed-
# form integrands take only 2^3 (single) / 2^5 (double) distinct values on
# their nucleotide grids.  The static count matrices below map the tiny
# distinct-value tables back onto the (4, 4, 4[, 4]) output (summing the
# internal nucleotides), replacing 256 / 4096 broadcast evaluations of a
# ~100/300-op transcendental formula with 8 / 32 — the Bell-class symmetry
# reduction of SURVEY.md section 7 item (d).
_TWO = np.array([-0.25, 0.75])


def _counts_single():
    eqi = np.eye(4, dtype=np.int64)  # 1 where nucleotides match
    a, b, c, d = np.ogrid[:4, :4, :4, :4]
    idx = eqi[a, d] * 4 + eqi[d, b] * 2 + eqi[d, c]  # (4,4,4,4)
    counts = np.zeros((64, 8), np.int64)
    flat = idx.reshape(64, 4)  # (abc, d)
    for k in range(4):
        np.add.at(counts, (np.arange(64), flat[:, k]), 1)
    return counts


def _counts_double():
    eqi = np.eye(4, dtype=np.int64)
    a, b, c, d, e, f = np.ogrid[:4, :4, :4, :4, :4, :4]
    idx = (eqi[a, e] * 16 + eqi[e, b] * 8 + eqi[e, f] * 4
           + eqi[f, c] * 2 + eqi[f, d])  # (4,4,4,4,4,4)
    counts = np.zeros((256, 32), np.int64)
    flat = idx.reshape(256, 16)  # (abcd, ef)
    for k in range(16):
        np.add.at(counts, (np.arange(256), flat[:, k]), 1)
    return counts


_COUNTS_SINGLE = _counts_single()  # (64, 8)
_COUNTS_DOUBLE = _counts_double()  # (256, 32)


def jc69_propagator(theta):
    """JC69 transition matrix after total scaled branch length ``theta``
    (= sum of mu_i * t_i).  Closed form of expm(theta * (J/4 - I))."""
    theta = jnp.asarray(theta)
    e = jnp.exp(-theta)[..., None, None]
    eq = jnp.asarray(_EQ, e.dtype)
    return 0.25 + eq * e


def _phi(x, xp=jnp):
    """(1 - exp(-x)) / x, the stable divided difference of exp: finite and
    accurate for every x including x == 0 (series there)."""
    small = xp.abs(x) < 1e-4
    safe = xp.where(small, 1.0, x)
    series = 1.0 - x * (0.5 - x * (1.0 / 6.0 - x / 24.0))
    return xp.where(small, series, -xp.expm1(-safe) / safe)


def _single_integrand(alpha, beta, gamma, t, mu, k, xp=jnp):
    """Reference JC69_analytical_integral (get_emission_prob_mat.py:47-92),
    restructured to remove the k ~= mu numerical cliff the reference
    inherits: its ``gamma/(mu - k)`` and ``gamma/(k - mu)`` terms cancel
    catastrophically (f64 error ~eps/|mu-k|, measured against an mpmath
    oracle); here the pair is the exact divided
    difference ``gamma * exp(-k t) * t * phi((mu - k) t)``, finite and
    fully accurate through k == mu.  Every ``1 - exp(-x)`` is ``-expm1``.
    ``xp`` selects the array module so tests can evaluate the identical
    algebra under an mpmath shim as a high-precision oracle."""
    ekt_m = xp.exp(-k * t)
    emt_m = xp.exp(-mu * t)
    one_m_ekt = -xp.expm1(-k * t)
    ab = alpha + beta
    km = -xp.expm1(-(k + mu) * t) / (k + mu)
    res = (
        one_m_ekt * (1.0 + 16.0 * ab * gamma * emt_m)
        + 4.0
        * k
        * (
            gamma * ekt_m * t * _phi((mu - k) * t, xp)
            + (ab + 16.0 * alpha * beta * gamma * emt_m) * km
            + 4.0 * alpha * beta * -xp.expm1(-(k + 2.0 * mu) * t)
            / (k + 2.0 * mu)
        )
    ) / (64.0 * one_m_ekt)
    return res


def coal_tensor_single(t, mu, k, dtype=jnp.float64):
    """F[a, b, c] = P(b, c | a) for one coalescence within time ``t`` at
    coalescent rate ``k`` (truncated-exponential), summed over the internal
    nucleotide (reference p_b_c_given_a_JC69_analytical, :95-117)."""
    two = jnp.asarray(_TWO, dtype)
    alpha = two[:, None, None]
    beta = two[None, :, None]
    gamma = two[None, None, :]
    table = _single_integrand(alpha, beta, gamma, t, mu, k).reshape(8)
    counts = jnp.asarray(_COUNTS_SINGLE, dtype)
    return (counts @ table).reshape(4, 4, 4)


# Half-width of the excluded band around the _double_integrand's removable
# singularities mu in {1, 2, 3}.  Measured against an mpmath oracle:
# un-guarded f64 cancellation at mu = 2 reaches 2.2e-5 at delta = 1e-6,
# 5.7e-3 at 1e-7, nan at the exact point; with the 1e-5 nudge the error vs
# the TRUE value stays <= ~2e-11 everywhere (the integrand is nearly flat
# across the removable point, so the nudge itself is free).
_MU_GUARD = 1e-5


def _double_integrand(alpha, beta, gamma, delta, epsilon, t, mu, xp=jnp):
    """Reference JC69_analytical_integral_double
    (get_emission_prob_mat.py:120-397); two coalescences of three lineages
    within ``t`` (pair rate 3, then 1 — baked into the constants).

    ``mu`` here is the substitution/coalescent rate ratio (model.py feeds
    (4/3) * N_ABC, ~1e-3 in any sane configuration).  The closed form has
    removable singularities at mu in {1, 2, 3} — reachable only at
    pathological bound corners, where the reference returns inf/nan and
    f64 cancellation nearby reaches 5.7e-3 relative at |mu - 2| = 1e-7
    (mpmath oracle).  mu is nudged off the singular set
    by at most _MU_GUARD; the measured error vs the true value with the
    nudge is <= ~2e-11 (the integrand is nearly flat across the removable
    point).  ``xp`` selects the array module (mpmath-shim oracle in
    tests)."""
    for s in (1.0, 2.0, 3.0):
        d = mu - s
        mu = xp.where(xp.abs(d) < _MU_GUARD,
                      s + xp.where(d < 0.0, -_MU_GUARD, _MU_GUARD), mu)
    em = xp.exp(mu * t)
    e2t = xp.exp(2.0 * t)
    p1 = (-1.0 + 2.0 * beta * (mu - 2.0)) * (2.0 + mu) + 2.0 * alpha * (mu - 2.0) * (
        2.0 + 8.0 * beta + mu
    )
    p2 = (1.0 + mu) * (2.0 + 8.0 * beta + mu) + 8.0 * alpha * (
        1.0 + mu + 2.0 * beta * (2.0 + mu)
    )
    p3 = 2.0 + mu + 8.0 * gamma * (1.0 + mu)
    mu2 = mu * mu

    a1 = (-2.0 * delta * (-2.0 - 8.0 * gamma + mu)) / (-6.0 + mu + mu2)
    a2 = -(32.0 * alpha * beta * delta * p3) / (3.0 * (1.0 + mu) ** 2 * (2.0 + mu))
    a3 = -(32.0 * alpha * beta * epsilon * p3) / (em * (1.0 + mu) * (2.0 + mu) * (3.0 + mu))
    a4 = -(8.0 * alpha * beta * (1.0 + 16.0 * delta * epsilon / em) * p3) / (
        (1.0 + mu) * (2.0 + mu) * (3.0 + 2.0 * mu)
    )
    a5 = (16.0 * delta * gamma * p1) / ((mu - 2.0) * (2.0 + mu) * (1.0 + 2.0 * mu))
    a6 = -(
        4.0
        * (alpha + beta)
        * (1.0 + 2.0 * gamma * (2.0 + mu))
        * (
            (3.0 + 2.0 * mu) * (3.0 * em + 4.0 * epsilon * (3.0 + mu))
            + 12.0 * delta * (em * (3.0 + mu) + 4.0 * epsilon * (3.0 + 2.0 * mu))
        )
    ) / (3.0 * em * (2.0 + mu) * (3.0 + mu) * (3.0 + 2.0 * mu))
    a7 = -(
        2.0
        * epsilon
        * (
            (2.0 + 8.0 * gamma - mu) / ((mu - 3.0) * (mu - 2.0))
            + p2 / ((mu - 1.0) * (1.0 + mu) * (2.0 + mu))
        )
    ) / em
    poly = 2.0 + 3.0 * mu + mu2
    a8 = -(
        -16.0 * delta * epsilon * (2.0 + 8.0 * gamma - mu) * poly
        + em * (-2.0 - 8.0 * gamma + mu) * poly
        - 3.0 * em * (mu - 2.0) * p2
        - 48.0 * epsilon * (2.0 * gamma * (1.0 + mu) * p1 + delta * (mu - 2.0) * p2)
    ) / (6.0 * em * (mu - 2.0) * (1.0 + mu) * (2.0 + mu))
    a9 = (
        2.0
        * (
            2.0 * em * gamma * (1.0 + mu) * p1
            + delta * (32.0 * epsilon * gamma * (1.0 + mu) * p1 + em * (mu - 2.0) * p2)
        )
    ) / (em * (1.0 + mu) ** 2 * (mu2 - 4.0))

    b1 = (32.0 * alpha * beta * delta * p3) / (3.0 * (1.0 + mu) ** 2 * (2.0 + mu))
    b2 = (32.0 * alpha * beta * em * epsilon * p3) / (
        (1.0 + mu) * (2.0 + mu) * (3.0 + mu)
    )
    b3 = (8.0 * alpha * beta * em * (1.0 + 16.0 * delta * epsilon / em) * p3) / (
        (1.0 + mu) * (2.0 + mu) * (3.0 + 2.0 * mu)
    )
    b4 = (
        4.0
        * (alpha + beta)
        * (1.0 + 2.0 * gamma * (2.0 + mu))
        * (
            (3.0 + 2.0 * mu) * (3.0 * em * em + 4.0 * em * em * epsilon * (3.0 + mu))
            + 12.0 * delta * (em * (3.0 + mu) + 4.0 * em * epsilon * (3.0 + 2.0 * mu))
        )
    ) / (3.0 * (2.0 + mu) * (3.0 + mu) * (3.0 + 2.0 * mu))

    c1 = (2.0 * delta * (-2.0 - 8.0 * gamma + mu)) / (e2t * (-6.0 + mu + mu2))
    c2 = -(16.0 * delta * gamma * p1) / (em * (mu - 2.0) * (2.0 + mu) * (1.0 + 2.0 * mu))
    c3 = (
        2.0
        * em
        * epsilon
        * (
            (2.0 + 8.0 * gamma - mu) / (e2t * (mu - 3.0) * (mu - 2.0))
            + p2 / ((mu - 1.0) * (1.0 + mu) * (2.0 + mu))
        )
    )
    c4 = (
        -16.0 * delta * epsilon * (2.0 + 8.0 * gamma - mu) * poly
        + em * (-2.0 - 8.0 * gamma + mu) * poly
        - 3.0 * e2t * em * (mu - 2.0) * p2
        - 48.0
        * e2t
        * epsilon
        * (2.0 * gamma * (1.0 + mu) * p1 + delta * (mu - 2.0) * p2)
    ) / (6.0 * e2t * (mu - 2.0) * (1.0 + mu) * (2.0 + mu))
    c5 = -(
        2.0
        * (
            2.0 * em * gamma * (1.0 + mu) * p1
            + delta * (32.0 * epsilon * gamma * (1.0 + mu) * p1 + em * (mu - 2.0) * p2)
        )
    ) / (em * (1.0 + mu) ** 2 * (mu2 - 4.0))

    inner = c1 + c2 + c3 + c4 + c5
    a10 = (b1 + b2 + b3 + b4 + xp.exp(2.0 * (1.0 + mu) * t) * inner) / xp.exp(
        3.0 * (1.0 + mu) * t
    )

    total = a1 + a2 + a3 + a4 + a5 + a6 + a7 + a8 + a9 + a10
    norm = 1024.0 * (1.0 + 0.5 / xp.exp(3.0 * t) - 1.5 / xp.exp(t))
    return 3.0 * total / norm


def coal_tensor_double(t, mu, dtype=jnp.float64):
    """D[a, b, c, d] = P(b, c, d | a) for two coalescences of lineages
    (a,b,c) within ``t``, summed over both internal nucleotides (reference
    p_b_c_d_given_a_JC69_analytical, :400-424)."""
    two = jnp.asarray(_TWO, dtype)
    alpha = two[:, None, None, None, None]
    beta = two[None, :, None, None, None]
    gamma = two[None, None, :, None, None]
    delta = two[None, None, None, :, None]
    epsilon = two[None, None, None, None, :]
    table = _double_integrand(alpha, beta, gamma, delta, epsilon, t,
                              mu).reshape(32)
    counts = jnp.asarray(_COUNTS_DOUBLE, dtype)
    return (counts @ table).reshape(4, 4, 4, 4)


def _emission_single(theta_a, theta_b, theta_c, theta_ab, theta_d,
                     t1, mu1, k1, t2, mu2, k2):
    """Emission 4-tensor for a hidden state with two coalescence events in
    different intervals (reference calc_emissions_single_JC69:484-608).

    Branch layout: species branches a/b join at the first event; their
    ancestor travels theta_ab, joins c at the second event; the root emits
    the outgroup d over theta_d.  The leading 1/4 is the uniform root prior.
    """
    pa = jc69_propagator(theta_a)  # P[a0, a1]
    pb = jc69_propagator(theta_b)  # P[b1, b0] (symmetric)
    pc = jc69_propagator(theta_c)
    pab = jc69_propagator(theta_ab)
    pd = jc69_propagator(theta_d)  # P[abc0, d0]
    f1 = coal_tensor_single(t1, mu1, k1)  # F[a1, b1, ab0]
    f2 = coal_tensor_single(t2, mu2, k2)  # F[ab1, c1, abc0]
    return 0.25 * jnp.einsum(
        "ax,yb,xyu,uv,vzw,zc,wd->abcd", pa, pb, f1, pab, f2, pc, pd
    )


def _emission_double(theta_a, theta_b, theta_c, theta_d, t, mu):
    """Emission 4-tensor for a hidden state whose two coalescence events fall
    in the same interval (reference calc_emissions_double_JC69:611-698)."""
    pa = jc69_propagator(theta_a)
    pb = jc69_propagator(theta_b)
    pc = jc69_propagator(theta_c)
    pd = jc69_propagator(theta_d)
    dd = coal_tensor_double(t, mu)  # D[a1, b1, c1, abc0]
    return 0.25 * jnp.einsum("ax,yb,zc,xyzw,wd->abcd", pa, pb, pc, dd, pd)


def emission_matrix(
    *,
    n_int_AB,
    n_int_ABC,
    t_A,
    t_B,
    t_C,
    t_AB,
    t_upper,
    t_out,
    coal_AB,
    coal_ABC,
    mu_A,
    mu_B,
    mu_C,
    mu_D,
    mu_AB,
    mu_ABC,
    cut_AB,
    cut_ABC,
    dtype=jnp.float64,
    extra_states=None,
):
    """Emission probability matrix ``b`` of shape (M, 256), rows ordered by
    the sorted hidden-state list (schedule.hidden_state_list), columns by the
    unambiguous 4-mer token order (a*64 + b*16 + c*4 + d over A,C,T,G).

    Mirrors the state-geometry driver of the reference
    (get_emission_prob_mat.py:701-1038): V1/V2/V3 deep-coalescence states
    with i<j (two single events), i==j (one double event), and V0 states
    (first event in the AB epoch).  V2/V3 reuse the V1 geometry with species
    permuted onto branches, then permute the emission axes back
    (:871-875, :897-899).
    """
    cut_AB = jnp.asarray(cut_AB, dtype)
    cut_ABC = jnp.asarray(cut_ABC, dtype)
    last = n_int_ABC - 1

    # -- geometry parameters per (i, j) with i < j (deep, two single events)
    pairs = np.array(
        [(i, j) for i in range(n_int_ABC) for j in range(i + 1, n_int_ABC)],
        dtype=np.int64,
    ).reshape(-1, 2)

    def deep_pair_params(i, j):
        is_last = j == last
        th_a = t_A * mu_A + t_AB * mu_AB + cut_ABC[i] * mu_ABC
        th_b = t_B * mu_B + t_AB * mu_AB + cut_ABC[i] * mu_ABC
        th_c = t_C * mu_C + cut_ABC[i] * mu_ABC
        th_ab = (cut_ABC[j] - cut_ABC[i + 1]) * mu_ABC
        t1 = cut_ABC[i + 1] - cut_ABC[i]
        t2 = jnp.where(is_last, t_upper, cut_ABC[jnp.minimum(j + 1, last)] - cut_ABC[j])
        add = jnp.where(
            is_last, 0.0, t_upper + cut_ABC[last] - cut_ABC[jnp.minimum(j + 1, last)]
        )
        th_d = t_out * mu_D + add * mu_ABC
        return th_a, th_b, th_c, th_ab, th_d, t1, t2

    # -- geometry per i (deep, double event in one interval)
    def deep_double_params(i):
        is_last = i == last
        th_a = t_A * mu_A + t_AB * mu_AB + cut_ABC[i] * mu_ABC
        th_b = t_B * mu_B + t_AB * mu_AB + cut_ABC[i] * mu_ABC
        th_c = t_C * mu_C + cut_ABC[i] * mu_ABC
        td = jnp.where(is_last, t_upper, cut_ABC[jnp.minimum(i + 1, last)] - cut_ABC[i])
        add = jnp.where(
            is_last, 0.0, t_upper + cut_ABC[last] - cut_ABC[jnp.minimum(i + 1, last)]
        )
        th_d = t_out * mu_D + add * mu_ABC
        return th_a, th_b, th_c, th_d, td

    # -- geometry per (i, j) for V0 (first event in the AB epoch)
    v0_pairs = np.array(
        [(i, j) for i in range(n_int_AB) for j in range(n_int_ABC)], dtype=np.int64
    ).reshape(-1, 2)

    def v0_params(i, j):
        is_last = j == last
        th_a = t_A * mu_A + cut_AB[i] * mu_AB
        th_b = t_B * mu_B + cut_AB[i] * mu_AB
        th_c = t_C * mu_C + cut_ABC[j] * mu_ABC
        th_ab = (t_AB - cut_AB[i + 1]) * mu_AB + cut_ABC[j] * mu_ABC
        t1 = cut_AB[i + 1] - cut_AB[i]
        t2 = jnp.where(is_last, t_upper, cut_ABC[jnp.minimum(j + 1, last)] - cut_ABC[j])
        add = jnp.where(
            is_last, 0.0, t_upper + cut_ABC[last] - cut_ABC[jnp.minimum(j + 1, last)]
        )
        th_d = t_out * mu_D + add * mu_ABC
        return th_a, th_b, th_c, th_ab, th_d, t1, t2

    out = {}

    if len(pairs):
        th_a, th_b, th_c, th_ab, th_d, t1, t2 = vmap(deep_pair_params)(
            pairs[:, 0], pairs[:, 1]
        )
        # V1: branches (A, B | C); V2: (A, C | B); V3: (B, C | A)
        em1 = vmap(
            lambda a, b, c, ab, d, x1, x2: _emission_single(
                a, b, c, ab, d, x1, mu_ABC, coal_ABC, x2, mu_ABC, coal_ABC
            )
        )
        v1 = em1(th_a, th_b, th_c, th_ab, th_d, t1, t2)
        v2 = em1(th_a, th_c, th_b, th_ab, th_d, t1, t2).transpose(0, 1, 3, 2, 4)
        v3 = em1(th_b, th_c, th_a, th_ab, th_d, t1, t2).transpose(0, 3, 1, 2, 4)
        for n, (i, j) in enumerate(pairs):
            out[(1, int(i), int(j))] = v1[n]
            out[(2, int(i), int(j))] = v2[n]
            out[(3, int(i), int(j))] = v3[n]

    idx = np.arange(n_int_ABC, dtype=np.int64)
    th_a, th_b, th_c, th_d, td = vmap(deep_double_params)(idx)
    em2 = vmap(lambda a, b, c, d, t: _emission_double(a, b, c, d, t, mu_ABC))
    d1 = em2(th_a, th_b, th_c, th_d, td)
    d2 = em2(th_a, th_c, th_b, th_d, td).transpose(0, 1, 3, 2, 4)
    d3 = em2(th_b, th_c, th_a, th_d, td).transpose(0, 3, 1, 2, 4)
    for n in range(n_int_ABC):
        out[(1, n, n)] = d1[n]
        out[(2, n, n)] = d2[n]
        out[(3, n, n)] = d3[n]

    th_a, th_b, th_c, th_ab, th_d, t1, t2 = vmap(v0_params)(
        v0_pairs[:, 0], v0_pairs[:, 1]
    )
    v0 = vmap(
        lambda a, b, c, ab, d, x1, x2: _emission_single(
            a, b, c, ab, d, x1, mu_AB, coal_AB, x2, mu_ABC, coal_ABC
        )
    )(th_a, th_b, th_c, th_ab, th_d, t1, t2)
    for n, (i, j) in enumerate(v0_pairs):
        out[(0, int(i), int(j))] = v0[n]

    from itrails_tpu.core.schedule import hidden_state_list

    if extra_states is not None:
        out.update(extra_states)
    hidden = hidden_state_list(n_int_AB, n_int_ABC, introgression=extra_states is not None)
    b = jnp.stack([out[h] for h in hidden])
    return b.reshape(len(hidden), 256)


def emission_matrix_introgression(
    *,
    n_int_AB,
    n_int_ABC,
    t_A,
    t_B,
    t_C,
    t_AB,
    t_m,
    t_upper,
    t_out,
    coal_AB,
    coal_BC,
    coal_ABC,
    mu,
    cut_AB,
    cut_ABC,
    dtype=jnp.float64,
):
    """Emission matrix for the introgression model (reference
    get_emission_prob_mat_introgression, int_get_emission_prob_mat.py:
    744-1110).

    ``t_B``/``t_C`` run from the present to the *migration* event; the
    V0-V3 geometries are the plain ones with the effective branch lengths
    ``t_B + t_m`` and ``t_C + t_m + t_AB``; the V4 (introgressed) states
    coalesce B with C in the BC epoch on the shifted cutpoint grid
    ``cut_BC = [0] + (cut_AB[1:] + t_m)`` at rate ``coal_BC``.
    """
    cut_AB = jnp.asarray(cut_AB, dtype)
    cut_ABC = jnp.asarray(cut_ABC, dtype)
    cut_BC = jnp.concatenate([jnp.zeros(1, dtype), cut_AB[1:] + t_m])
    last = n_int_ABC - 1

    v4_pairs = np.array(
        [(i, j) for i in range(n_int_AB) for j in range(n_int_ABC)], dtype=np.int64
    ).reshape(-1, 2)

    def v4_params(i, j):
        is_last = j == last
        th_a = t_B * mu + cut_BC[i] * mu  # branch x = species B
        th_b = t_C * mu + cut_BC[i] * mu  # branch y = species C
        th_c = (t_A + t_AB) * mu + cut_ABC[j] * mu  # branch z = species A
        th_ab = (t_AB + t_m - cut_BC[i + 1]) * mu + cut_ABC[j] * mu
        t1 = cut_BC[i + 1] - cut_BC[i]
        t2 = jnp.where(is_last, t_upper, cut_ABC[jnp.minimum(j + 1, last)] - cut_ABC[j])
        add = jnp.where(
            is_last, 0.0, t_upper + cut_ABC[last] - cut_ABC[jnp.minimum(j + 1, last)]
        )
        th_d = t_out * mu + add * mu
        return th_a, th_b, th_c, th_ab, th_d, t1, t2

    th_a, th_b, th_c, th_ab, th_d, t1, t2 = vmap(v4_params)(
        v4_pairs[:, 0], v4_pairs[:, 1]
    )
    v4 = vmap(
        lambda a, b, c, ab, d, x1, x2: _emission_single(
            a, b, c, ab, d, x1, mu, coal_BC, x2, mu, coal_ABC
        )
    )(th_a, th_b, th_c, th_ab, th_d, t1, t2)
    # branches (B, C, A): back to (A, B, C, D) axis order (reference
    # int_get_emission_prob_mat.py:1098-1100)
    v4 = v4.transpose(0, 3, 1, 2, 4)
    extra = {
        (4, int(i), int(j)): v4[n] for n, (i, j) in enumerate(v4_pairs)
    }

    return emission_matrix(
        n_int_AB=n_int_AB,
        n_int_ABC=n_int_ABC,
        t_A=t_A,
        t_B=t_B + t_m,
        t_C=t_C + t_m + t_AB,
        t_AB=t_AB,
        t_upper=t_upper,
        t_out=t_out,
        coal_AB=coal_AB,
        coal_ABC=coal_ABC,
        mu_A=mu,
        mu_B=mu,
        mu_C=mu,
        mu_D=mu,
        mu_AB=mu,
        mu_ABC=mu,
        cut_AB=cut_AB,
        cut_ABC=cut_ABC,
        dtype=dtype,
        extra_states=extra,
    )
