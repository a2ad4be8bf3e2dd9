"""Exact-gradient path: remat forward parity, expm VJP, engine gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from itrails_tpu.core.expm import expm_batch
from itrails_tpu.data.tokens import PAD_TOKEN
from itrails_tpu.hmm import decoders
from itrails_tpu.hmm.grad import forward_loglik_remat


def _random_model(m, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.random((m, m))
    a /= a.sum(1, keepdims=True)
    bfull = rng.random((m, 625)) * 0.01 + 1e-4
    pi = rng.random(m)
    pi /= pi.sum()
    return jnp.asarray(a), jnp.asarray(bfull), jnp.asarray(pi)


def test_remat_forward_matches_scan():
    a, bfull, pi = _random_model(11)
    rng = np.random.default_rng(1)
    tokens = np.asarray(rng.integers(0, 625, size=(3, 70)), np.int32)
    tokens[1, 40:] = PAD_TOKEN
    tokens = jnp.asarray(tokens)
    ll_remat = float(forward_loglik_remat(a, bfull, pi, tokens, chunk=16))
    ll_ref = float(decoders.forward_loglik(a, bfull, pi, tokens))
    np.testing.assert_allclose(ll_remat, ll_ref, rtol=1e-9)


def test_expm_grad_matches_finite_differences():
    rng = np.random.default_rng(2)
    a = jnp.asarray(rng.normal(size=(5, 5)) * 2.0)
    w = jnp.asarray(rng.normal(size=(5, 5)))

    def f(x):
        return jnp.sum(expm_batch(x[None])[0] * w)

    g = jax.grad(f)(a)
    eps = 1e-6
    i, j = 2, 3
    ap = a.at[i, j].add(eps)
    am = a.at[i, j].add(-eps)
    fd = (float(f(ap)) - float(f(am))) / (2 * eps)
    np.testing.assert_allclose(float(g[i, j]), fd, rtol=1e-5)


def test_decode_grads_match_finite_differences():
    a, bfull, pi = _random_model(7, seed=3)
    rng = np.random.default_rng(4)
    tokens = jnp.asarray(rng.integers(0, 625, size=(2, 45)), jnp.int32)

    vg = jax.value_and_grad(forward_loglik_remat, argnums=(0, 1, 2))
    _, (da, dbfull, dpi) = vg(a, bfull, pi, tokens)

    eps = 1e-7
    f = lambda a_, b_, p_: float(forward_loglik_remat(a_, b_, p_, tokens))
    fd_a = (f(a.at[1, 2].add(eps), bfull, pi)
            - f(a.at[1, 2].add(-eps), bfull, pi)) / (2 * eps)
    np.testing.assert_allclose(float(da[1, 2]), fd_a, rtol=1e-4)
    fd_p = (f(a, bfull, pi.at[0].add(eps))
            - f(a, bfull, pi.at[0].add(-eps))) / (2 * eps)
    np.testing.assert_allclose(float(dpi[0]), fd_p, rtol=1e-4)
    tok = int(np.asarray(tokens)[0, 5])
    fd_b = (f(a, bfull.at[3, tok].add(eps), pi)
            - f(a, bfull.at[3, tok].add(-eps), pi)) / (2 * eps)
    np.testing.assert_allclose(float(dbfull[3, tok]), fd_b, rtol=1e-4)


@pytest.mark.slow
def test_engine_gradient_matches_finite_differences():
    from itrails_tpu.optim.cases import resolve_times
    from itrails_tpu.optim.optimizer import LoglikEngine

    rng = np.random.default_rng(5)
    v_lst = [rng.integers(0, 625, size=150).astype(np.int64)]
    eng = LoglikEngine(v_lst, 1, 1, dtype="float64")
    optim_vars = ["t_1", "N_ABC"]
    fixed = {"n_int_AB": 1, "n_int_ABC": 1, "t_2": 0.0004,
             "t_upper": 0.00745069, "N_AB": 0.0005, "r": 1.0}
    case = frozenset(["t_1"])
    vg = eng.loglik_and_grad_fn(optim_vars, fixed, case, resolve_times)
    x0 = np.array([0.0024, 0.0005])
    ll, g = vg(x0)

    def f(x):
        d = dict(fixed)
        for n, v in zip(optim_vars, x):
            d[n] = float(v)
        return eng.loglik(resolve_times(case, d))

    np.testing.assert_allclose(ll, f(x0), rtol=1e-10)
    for k in range(2):
        eps = x0[k] * 1e-6
        e = np.zeros(2)
        e[k] = eps
        fd = (f(x0 + e) - f(x0 - e)) / (2 * eps)
        np.testing.assert_allclose(g[k], fd, rtol=1e-3)


def test_optimizer_use_grad_smoke(tmp_path):
    from itrails_tpu.optim.optimizer import optimizer

    rng = np.random.default_rng(6)
    v_lst = [rng.integers(0, 625, size=120).astype(np.int64)]
    res = optimizer(
        optim_variables=["t_1", "N_ABC"],
        optim_list=[0.0024, 0.0005],
        bounds=[(1e-4, 0.01), (1e-4, 0.005)],
        fixed_params={"n_int_AB": 1, "n_int_ABC": 1, "t_2": 0.0004,
                      "t_upper": 0.00745069, "N_AB": 0.0005, "r": 1.0},
        v_lst=v_lst,
        res_name=str(tmp_path / "run"),
        case=frozenset(["t_1"]),
        method="L-BFGS-B",
        maxiter=3,
        use_grad=True,
    )
    assert np.isfinite(res.fun)
    hist = (tmp_path / "run.optimization_history.csv").read_text().splitlines()
    assert len(hist) > 1


@pytest.mark.slow
def test_int_gradient_fd_parity_at_stall_point():
    """An unscaled introgression L-BFGS-B+grad run once stalled at its
    start point.  This pins that the exact gradient there is
    CORRECT — central finite differences agree to ~1e-7 — so the stall was
    a line-search geometry problem (unscaled variables), not a wrong or
    discontinuous gradient at the t_1/t_m case boundary."""
    from itrails_tpu.data.tokens import aggregation_matrix
    from itrails_tpu.introgression.builder import build_model_introgression_fn
    from itrails_tpu.optim.cases import resolve_times_introgression

    fixed = {"n_int_AB": 3, "n_int_ABC": 3, "t_2": 0.0004, "t_m": 0.0008,
             "t_upper": 745069.3855e-8, "N_AB": 0.0005, "N_BC": 0.0004,
             "N_ABC": 0.0005, "r": 1.0}
    variables = ["t_1", "m"]
    x0 = np.array([0.0030, 0.25])  # the GRADEVAL stall point
    build = build_model_introgression_fn(3, 3, "float64", device=None)
    names = ["t_A", "t_B", "t_C", "t_2", "t_upper", "t_out", "t_m",
             "N_AB", "N_BC", "N_ABC", "r", "m"]
    agg = jnp.asarray(aggregation_matrix(), jnp.float64)
    rng = np.random.default_rng(0)
    tokens = jnp.asarray(rng.integers(0, 625, size=(16, 512)), jnp.int32)

    def f(vec):
        d = dict(fixed)
        for n, v in zip(variables, vec):
            d[n] = v
        d = resolve_times_introgression(frozenset(["t_1"]), d)
        a, b, pi, _, _ = build(*[d[n] for n in names])
        bfull = decoders.emission_table(b, agg)
        return decoders.forward_loglik(a, bfull, pi, tokens)

    ll, g = jax.value_and_grad(f)(jnp.asarray(x0))
    assert np.isfinite(float(ll))
    for i, h in ((0, 1e-7), (1, 1e-6)):
        e = np.zeros(2)
        e[i] = h
        fd = (float(f(jnp.asarray(x0 + e)))
              - float(f(jnp.asarray(x0 - e)))) / (2 * h)
        np.testing.assert_allclose(float(g[i]), fd, rtol=5e-6)


def test_use_grad_scaled_space_handles_disparate_magnitudes(tmp_path):
    """The grad path optimizes in z = x/|x0| so t-scale (1e-3) and
    proportion-scale (0.25) variables see O(1) line-search steps; the
    optimizer must actually move off a start point whose gradient spans
    5 orders of magnitude (the round-3 stall mode), and report results in
    natural coordinates."""
    from itrails_tpu.optim.optimizer import optimizer

    rng = np.random.default_rng(9)
    v_lst = [rng.integers(0, 625, size=200).astype(np.int64)]
    res = optimizer(
        optim_variables=["t_1", "m"],
        optim_list=[0.0030, 0.25],
        bounds=[(0.00024, 0.024), (0.001, 0.99)],
        fixed_params={"n_int_AB": 1, "n_int_ABC": 2, "t_2": 0.0004,
                      "t_m": 0.0008, "t_upper": 745069.3855e-8,
                      "N_AB": 0.0005, "N_BC": 0.0004, "N_ABC": 0.0005,
                      "r": 1.0},
        v_lst=v_lst,
        res_name=str(tmp_path / "run"),
        case=frozenset(["t_1"]),
        method="L-BFGS-B",
        maxiter=6,
        use_grad=True,
        introgression=True,
    )
    # natural coordinates (not z-space ~1.0), inside bounds
    assert 0.00024 <= res.x[0] <= 0.024
    assert 0.001 <= res.x[1] <= 0.99
    hist = np.loadtxt(tmp_path / "run_optimization_history.csv",
                      delimiter=",", skiprows=1, ndmin=2)
    # history records natural coordinates too
    assert hist[0, 1] == pytest.approx(0.0030, rel=1e-9)
    # the optimizer moved off the start point (the round-3 stall symptom)
    assert np.abs(hist[:, 1] - 0.0030).max() > 1e-6
