"""Dense-grid parity of the JC69 closed-form coalescence integrals."""

import numpy as np

from itrails_tpu.core.emissions import _double_integrand, _single_integrand
from tests.conftest import load_golden


def _eq(x, y):
    return 0.75 if x == y else -0.25


def test_single_integrand_grid():
    g = load_golden("integrands.npz")
    for ni, (a, b, c, d) in enumerate(g["nucs"]):
        alpha = _eq(a, d)
        beta = _eq(d, b)
        gamma = _eq(d, c)
        for ti, t in enumerate(g["ts"]):
            for mi, mu in enumerate(g["mus"]):
                for ki, k in enumerate(g["ks"]):
                    mine = float(_single_integrand(alpha, beta, gamma, t, mu, k))
                    np.testing.assert_allclose(
                        mine, g["single"][ni, ti, mi, ki], rtol=1e-11, atol=1e-13,
                        err_msg=f"nucs={a}{b}{c}{d} t={t} mu={mu} k={k}",
                    )


def test_double_integrand_grid():
    g = load_golden("integrands.npz")
    for ni, (a, b, c, d, e, f) in enumerate(g["nucs6"]):
        al = _eq(a, e)
        be = _eq(e, b)
        ga = _eq(e, f)
        de = _eq(f, c)
        ep = _eq(f, d)
        for ti, t in enumerate(g["ts"]):
            for mi, mu in enumerate(g["mus"]):
                mine = float(_double_integrand(al, be, ga, de, ep, t, mu))
                np.testing.assert_allclose(
                    mine, g["double"][ni, ti, mi], rtol=1e-10, atol=1e-13,
                    err_msg=f"nucs={a}{b}{c}{d}{e}{f} t={t} mu={mu}",
                )


class _MPX:
    """Scalar mpmath shim for the integrands' ``xp`` argument — the same
    algebra at 60 digits is the high-precision oracle (the cancellation at
    the removable singularities is precision-limited, not
    formula-limited)."""

    def __init__(self):
        from mpmath import mp

        mp.dps = 60
        self.exp = mp.exp
        self.expm1 = mp.expm1

    @staticmethod
    def where(c, a, b):
        return a if c else b

    @staticmethod
    def abs(x):
        return abs(x)


def test_single_integrand_near_k_equals_mu():
    """k == mu is a removable singularity of the reference formula
    (get_emission_prob_mat.py:47-92, gamma/(mu-k) + gamma/(k-mu)); the
    restructured divided-difference form must stay accurate through it
    (measured <= 2e-16; the naive form is inf at the point and ~4e-6 at
    |k/mu - 1| = 1e-10)."""
    from mpmath import mp

    xp = _MPX()
    for a, b, c in [(0.75, 0.75, 0.75), (0.75, -0.25, 0.75),
                    (-0.25, -0.25, -0.25)]:
        al, be, ga = a / 4, b / 4, c / 4
        for t, mu in [(0.8, 0.01), (0.05, 0.0007), (2.5, 0.4)]:
            for d in (1e-2, 1e-6, 1e-8, 1e-12, 0.0, -1e-8):
                k = mu * (1.0 + d)
                got = float(_single_integrand(al, be, ga, t, mu, k))
                want = _single_integrand(
                    mp.mpf(al), mp.mpf(be), mp.mpf(ga), mp.mpf(t),
                    mp.mpf(mu), mp.mpf(mu) * (1 + mp.mpf(d)), xp=xp)
                assert abs(got - float(want)) <= 1e-13 * abs(float(want)), (
                    f"k/mu-1={d}: {got} vs {want}")


def test_double_integrand_near_integer_mu():
    """mu in {1, 2, 3} are removable singularities of the reference
    formula (get_emission_prob_mat.py:120-397: (mu-1), (mu-2), (mu-3),
    (mu^2-4) denominators; nan at the exact points, 5.7e-3 relative error
    at |mu-2| = 1e-7).  The _MU_GUARD nudge must hold the error vs the
    TRUE (un-nudged) value to ~1e-9 through the whole band."""
    from mpmath import mp

    xp = _MPX()
    args = (0.75 / 4, -0.25 / 4, 0.75 / 4, -0.25 / 4, 0.75 / 4)
    margs = tuple(mp.mpf(x) for x in args)
    for s in (1.0, 2.0, 3.0):
        for d in (1e-3, 1e-6, 1e-7, 0.0, -1e-7, -1e-6):
            mu = s + d
            for t in (0.8, 0.2):
                got = float(_double_integrand(*args, t, mu))
                assert np.isfinite(got)
                m_true = mp.mpf(s) + mp.mpf(d)
                if d == 0.0:  # oracle at the removable limit
                    m_true += mp.mpf("1e-15")
                want = float(_double_integrand(*margs, mp.mpf(t), m_true,
                                               xp=xp))
                assert abs(got - want) <= 1e-9 * abs(want), (
                    f"mu={s}+{d}, t={t}: {got} vs {want}")
