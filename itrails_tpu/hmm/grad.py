"""Exact gradients of the forward log-likelihood.

The reference optimizes derivative-free only (scipy Nelder-Mead /
finite-difference L-BFGS-B over a rebuilt model per eval, reference
optimizer.py:586-637).  Here the whole pipeline params -> (a, b, pi) ->
log-likelihood is differentiable JAX, so the outer optimizer can use exact
gradients:

* ``forward_loglik_remat`` — the Rabiner-scaled linear forward written as a
  scan over T-chunks with ``jax.checkpoint`` on the chunk body, so
  reverse-mode memory is O(W*M*(T/chunk + chunk)) instead of O(W*M*T);
* ``decode_value_and_grad`` — jitted value+grad of the decode with respect
  to (a, bfull, pi), data-parallel over a device mesh (psum of the scalar
  and each cotangent);
* the builder side runs through ``jax.vjp`` of core.model's jitted build
  (expm carries a custom VJP — core/expm.py), chaining decode cotangents
  back to the demographic parameters.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from itrails_tpu.data.tokens import PAD_TOKEN
from itrails_tpu.hmm import triton_hmm
from itrails_tpu.hmm.decoders import highest_precision
from itrails_tpu.hmm.triton_hmm import ACC_DTYPE

__all__ = ["forward_loglik_remat", "loglik_and_grads",
           "decode_value_and_grad_fn"]


@highest_precision
def forward_loglik_remat(a, bfull, pi, tokens, chunk: int = 1024):
    """Total log-likelihood of a (W, T) token batch; reverse-differentiable
    with chunked rematerialization.  Matches decoders.forward_loglik (the
    total is float64 when x64 is on, whatever the input dtype)."""
    w, t_len = tokens.shape
    bt = bfull.T  # (625, M)

    tok0 = tokens[:, 0]
    pad0 = (tok0 == PAD_TOKEN)[:, None]
    e0 = jnp.where(pad0, jnp.ones((w, a.shape[0]), bt.dtype),
                   bt[jnp.maximum(tok0, 0)])
    al = pi[None, :] * e0
    s0 = jnp.sum(al, axis=1)
    al = al / s0[:, None]
    # per-window log-norms accumulate in f64 (when x64 is on): in f32 the
    # rounding of a long window's ~1e4-nat sum reaches ~5e-5 relative
    acc = jnp.log(s0).astype(ACC_DTYPE)

    rest = tokens[:, 1:]
    tc = min(chunk, max(rest.shape[1], 1))
    n_chunks = -(-rest.shape[1] // tc) if rest.shape[1] else 0
    if n_chunks == 0:
        return jnp.sum(acc)
    pad_cols = n_chunks * tc - rest.shape[1]
    rest = jnp.pad(rest, ((0, 0), (0, pad_cols)),
                   constant_values=PAD_TOKEN)
    chunks = rest.T.reshape(n_chunks, tc, w)

    def step(carry, tok):
        al, acc = carry
        pad = (tok == PAD_TOKEN)[:, None]
        e = jnp.where(pad, jnp.ones_like(al), bt[jnp.maximum(tok, 0)])
        nx = (al @ a) * e
        s = jnp.sum(nx, axis=1, keepdims=True)
        snz = jnp.where(pad, 1.0, s)
        al = jnp.where(pad, al, nx / snz)
        acc = acc + jnp.where(pad[:, 0], 0.0,
                              jnp.log(snz[:, 0])).astype(ACC_DTYPE)
        return (al, acc), None

    @jax.checkpoint
    def chunk_body(carry, toks):
        carry, _ = lax.scan(step, carry, toks)
        return carry, None

    (al, acc), _ = lax.scan(chunk_body, (al, acc), chunks)
    return jnp.sum(acc)


def loglik_and_grads(a, bfull, pi, tokens, chunk: int = 1024):
    """``(ll, (da, dbfull, dpi))`` of a (W, T) token batch: the one
    dispatcher for the decode gradient.  A float32 request compiled for a
    CUDA device, at a width the kernel serves (triton_hmm.serves_gradient),
    runs the Pallas-Triton Baum-Welch kernels
    (hmm.triton_hmm.loglik_and_grads); every other request runs reverse-mode
    autodiff of :func:`forward_loglik_remat` (float64 requests stay in
    float64).  The platform choice follows the platform the computation is
    compiled for (``lax.platform_dependent``)."""

    def autodiff(a, bfull, pi, tokens):
        return jax.value_and_grad(
            functools.partial(forward_loglik_remat, chunk=chunk),
            argnums=(0, 1, 2),
        )(a, bfull, pi, tokens)

    if bfull.dtype != jnp.float32 or not triton_hmm.serves_gradient(
            a.shape[0]):
        return autodiff(a, bfull, pi, tokens)
    return lax.platform_dependent(
        a, bfull, pi, tokens,
        cuda=triton_hmm.loglik_and_grads, default=autodiff,
    )


def decode_value_and_grad_fn(mesh=None, chunk: int = 1024):
    """Jitted ``(a, bfull, pi, tokens) -> (ll, (da, dbfull, dpi))`` with the
    window axis sharded over ``mesh`` (cotangents psum over devices)."""
    vg = functools.partial(loglik_and_grads, chunk=chunk)

    if mesh is None:
        return jax.jit(vg)

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P("data", None)),
        out_specs=(P(), (P(), P(), P())),
        check_vma=False,
    )
    def f(a, bfull, pi, tokens):
        ll, grads = vg(a, bfull, pi, tokens)
        return (
            jax.lax.psum(ll, "data"),
            tuple(jax.lax.psum(g, "data") for g in grads),
        )

    return f
