"""Pallas-Triton forward and gradient kernels (hmm.triton_hmm) in interpret
mode against the float64 scan and float64 autodiff, and the dispatch that
chooses between kernel and scan.  The compiled kernels run on the card in
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from itrails_tpu.data.tokens import PAD_TOKEN
from itrails_tpu.hmm import decoders, grad, triton_hmm
from itrails_tpu.hmm.grad import forward_loglik_remat


def _model(m, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.random((m, m)) + np.eye(m) * m
    a /= a.sum(1, keepdims=True)
    bfull = rng.random((m, 625)) * 0.01 + 1e-4
    pi = rng.random(m)
    pi /= pi.sum()
    return tuple(jnp.asarray(x) for x in (a, bfull, pi))


def _tokens(w, t, seed=1, pad_from=None, empty=None):
    """Random tokens over the whole alphabet (N-ambiguity tokens >= 256
    included) with optional PAD tails and an all-PAD window."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 625, size=(w, t)).astype(np.int32)
    tok[0, 0] = 624  # NNNN
    if pad_from is not None:
        tok[1 % w, pad_from:] = PAD_TOKEN
    if empty is not None:
        tok[empty, :] = PAD_TOKEN
    return jnp.asarray(tok)


def _f32(*xs):
    return tuple(x.astype(jnp.float32) for x in xs)


CASES = {  # name: (M, W, T, tokens kwargs, chunk_t)
    "m9_multi_chunk": (9, 3, 70, dict(pad_from=41), 16),
    "m27_odd_w": (27, 5, 33, dict(pad_from=20, empty=4), 8),
    "m36_odd_w": (36, 17, 5, dict(), 64),
    "m133": (133, 2, 6, dict(pad_from=3), 4),
    "t1": (9, 3, 1, dict(empty=2), 64),
    "t2": (9, 3, 2, dict(), 64),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_kernel_matches_f64_scan(case):
    m, w, t, kw, chunk = CASES[case]
    a, bfull, pi = _model(m)
    tok = _tokens(w, t, **kw)
    per_window = triton_hmm.forward_logliks(*_f32(a, bfull, pi), tok,
                                            chunk_t=chunk, interpret=True)
    _, ref = decoders.forward(a, bfull, pi, tok)
    assert per_window.shape == (w,)
    np.testing.assert_allclose(np.asarray(per_window), np.asarray(ref),
                               rtol=2e-6, atol=1e-5)
    total = triton_hmm.forward_loglik(*_f32(a, bfull, pi), tok,
                                      chunk_t=chunk, interpret=True)
    assert total.dtype == jnp.float64
    np.testing.assert_allclose(float(total), float(jnp.sum(ref)), rtol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_gradient_kernel_matches_f64_autodiff(case):
    m, w, t, kw, chunk = CASES[case]
    a, bfull, pi = _model(m, seed=2)
    tok = _tokens(w, t, seed=3, **kw)
    ll, grads = triton_hmm.loglik_and_grads(*_f32(a, bfull, pi), tok,
                                            chunk_t=chunk, interpret=True)
    ll_r, grads_r = jax.value_and_grad(
        lambda *x: forward_loglik_remat(*x, tok, chunk=32),
        argnums=(0, 1, 2))(a, bfull, pi)
    np.testing.assert_allclose(float(ll), float(ll_r), rtol=1e-6)
    for g, r in zip(grads, grads_r):
        assert g.shape == r.shape and g.dtype == jnp.float32
        scale = np.abs(np.asarray(r)).max()
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   atol=1e-4 * scale)


def test_padding_is_neutral():
    """Extra all-PAD windows and PAD columns change nothing."""
    a, bfull, pi = _f32(*_model(9))
    tok = _tokens(3, 20)
    padded = jnp.full((21, 37), PAD_TOKEN, jnp.int32).at[:3, :20].set(tok)
    ll = triton_hmm.forward_logliks(a, bfull, pi, tok, interpret=True)
    ll_p = triton_hmm.forward_logliks(a, bfull, pi, padded, interpret=True)
    np.testing.assert_allclose(np.asarray(ll_p[:3]), np.asarray(ll),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ll_p[3:]), 0.0, atol=1e-6)


@pytest.mark.parametrize("m,mp", [(9, 32), (27, 32), (36, 64), (133, 160),
                                  (182, 192)])
def test_state_padding(m, mp):
    assert triton_hmm.padded_states(m) == mp


@pytest.mark.parametrize("m,served", [(27, True), (36, True), (64, True),
                                      (65, False), (133, False),
                                      (182, False)])
def test_gradient_kernel_serves_measured_widths(m, served):
    assert triton_hmm.serves_gradient(m) is served


TRITON_CALL = "__gpu$xla.gpu.triton"  # custom-call target of the kernels


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("which", ["forward", "gradient"])
def test_dispatch_compiles_the_scan_on_cpu(which, dtype):
    """The platform the program compiles for picks the path: on the CPU
    the scan, whatever the dtype, and bit-for-bit the scan's value."""
    a, bfull, pi = (x.astype(dtype) for x in _model(27))
    tok = _tokens(4, 30, pad_from=12)
    if which == "forward":
        fn, ref = decoders.forward_loglik_fast, lambda *x: triton_hmm.total(
            decoders.forward(*x)[1])
    else:
        fn, ref = grad.loglik_and_grads, jax.value_and_grad(
            lambda *x: forward_loglik_remat(*x[:3], x[3]),
            argnums=(0, 1, 2))
    assert TRITON_CALL not in _compiled(fn, a, bfull, pi, tok)
    got = jax.tree.leaves(jax.jit(fn)(a, bfull, pi, tok))
    want = jax.tree.leaves(jax.jit(ref)(a, bfull, pi, tok))
    for g, r in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), rtol=1e-12)


def test_sharded_objective_uses_the_dispatch_on_cpu():
    from itrails_tpu.hmm import sharding

    mesh = sharding.data_mesh()
    a, bfull, pi = _f32(*_model(27))
    tok = _tokens(mesh.devices.size, 24)
    f = sharding.sharded_loglik_fn(mesh)
    tok = sharding.shard_batch(tok, mesh)
    assert TRITON_CALL not in f.lower(a, bfull, pi, tok).compile().as_text()
    np.testing.assert_allclose(
        float(f(a, bfull, pi, tok)),
        float(decoders.forward_loglik(a, bfull, pi, tok)), rtol=1e-6)


@pytest.mark.gpu
def test_compiled_kernels_on_the_card():
    """Card-only: the compiled kernels at a small width (chip_smoke.py
    checks them at the real widths)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this on the card")
    a, bfull, pi = _model(27)
    tok = _tokens(64, 300, pad_from=100)
    ll = triton_hmm.forward_loglik(*_f32(a, bfull, pi), tok)
    ref = decoders.forward_loglik(a, bfull, pi, tok)
    np.testing.assert_allclose(float(ll), float(ref), rtol=1e-5)
