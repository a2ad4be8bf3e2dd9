"""Batched matrix exponential for JAX.

Single code path: degree-13 Pade approximant with scaling-and-squaring
(Higham 2008, Alg. 10.20 — the same family the reference's numba kernel uses,
reference expm.py:9-167, but restructured for XLA):

* no data-dependent Python branching — the scaling power ``s`` is a traced
  integer per batch element and the squaring phase is a ``lax.while_loop``
  that runs ``max(s)`` batched matmul iterations with per-element masking;
* always Pade-13 (for small norms this is strictly more accurate than the
  reference's lower-degree branches, so parity tolerances hold);
* operates on a batch ``(..., n, n)`` so every CTMC propagator of a model
  build is one fused batched call.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["expm", "expm_batch"]

_THETA13 = 5.371920351148152  # Pade-13 1-norm threshold (Higham 2008, Tab. 10.2)

_B13 = (
    64764752532480000.0,
    32382376266240000.0,
    7771770303897600.0,
    1187353796428800.0,
    129060195264000.0,
    10559470521600.0,
    670442572800.0,
    33522128640.0,
    1323241920.0,
    40840800.0,
    960960.0,
    16380.0,
    182.0,
    1.0,
)


def _one_norm(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.max(jnp.sum(jnp.abs(a), axis=-2), axis=-1)


@jax.custom_vjp
def expm_batch(a: jnp.ndarray) -> jnp.ndarray:
    """Matrix exponential of a batch of square matrices ``(..., n, n)``.

    Reverse-differentiable: the squaring phase is a ``lax.while_loop`` (not
    AD-friendly), so the VJP is supplied analytically via the Frechet
    derivative of expm — ``L(A, E) = expm([[A, E], [0, A]])[:n, n:]`` and
    the adjoint identity ``vjp(A, G) = L(A^T, G)`` (Higham 2008, §10.6) —
    one 2n x 2n exponential per cotangent.
    """
    return _expm_impl(a)


def _expm_impl(a: jnp.ndarray) -> jnp.ndarray:
    b = _B13
    dtype = a.dtype
    n = a.shape[-1]
    batch_shape = a.shape[:-2]

    norm = _one_norm(a)
    # per-element scaling power: s = max(0, ceil(log2(norm / theta13)))
    safe = jnp.maximum(norm, jnp.finfo(dtype).tiny)
    s = jnp.maximum(0, jnp.ceil(jnp.log2(safe / _THETA13)).astype(jnp.int32))
    scale = jnp.exp2(-s.astype(dtype))
    a = a * scale[..., None, None]

    # diagonal adds instead of materialised eye broadcasts: the (B, n, n)
    # identity broadcasts were ~10% of the 7x7 build on CPU
    diag = jnp.arange(n)

    def add_diag(x, c):
        return x.at[..., diag, diag].add(c)

    a2 = a @ a
    a4 = a2 @ a2
    a6 = a2 @ a4
    u = a @ add_diag(
        a6 @ (b[13] * a6 + b[11] * a4 + b[9] * a2)
        + b[7] * a6
        + b[5] * a4
        + b[3] * a2,
        b[1],
    )
    v = add_diag(
        a6 @ (b[12] * a6 + b[10] * a4 + b[8] * a2)
        + b[6] * a6
        + b[4] * a4
        + b[2] * a2,
        b[0],
    )
    x = jnp.linalg.solve(v - u, v + u)

    def cond(state):
        k, _ = state
        return jnp.any(k < s)

    def body(state):
        k, x = state
        mask = (k < s)[..., None, None]
        x = jnp.where(mask, x @ x, x)
        return k + 1, x

    _, x = lax.while_loop(cond, body, (jnp.zeros(batch_shape, jnp.int32), x))
    return x


def _expm_frechet(a, e):
    """Frechet derivative ``L(a, e)`` of the degree-13 Pade expm, by
    differentiating the Pade evaluation directly (Al-Mohy & Higham 2009,
    Alg. 6.4 structure): the same scaling ``s`` and polynomial recurrences
    as :func:`_expm_impl` with product-rule companions, two n-sized solves
    against the shared denominator, and ``L <- XL + LX`` through the
    squaring phase.  Replaces the 2n-block-matrix method
    (``expm([[A,E],[0,A]])``), whose (2n)-sized LU dominated the model
    build VJP on XLA:CPU (~8x the factorization flops of this form)."""
    b = _B13
    dtype = a.dtype
    n = a.shape[-1]
    batch_shape = a.shape[:-2]

    norm = _one_norm(a)
    safe = jnp.maximum(norm, jnp.finfo(dtype).tiny)
    s = jnp.maximum(0, jnp.ceil(jnp.log2(safe / _THETA13)).astype(jnp.int32))
    scale = jnp.exp2(-s.astype(dtype))
    a = a * scale[..., None, None]
    e = e * scale[..., None, None]

    diag = jnp.arange(n)

    def add_diag(x, c):
        return x.at[..., diag, diag].add(c)

    a2 = a @ a
    m2 = a @ e + e @ a
    a4 = a2 @ a2
    m4 = a2 @ m2 + m2 @ a2
    a6 = a2 @ a4
    m6 = a2 @ m4 + m2 @ a4
    w1 = b[13] * a6 + b[11] * a4 + b[9] * a2
    lw1 = b[13] * m6 + b[11] * m4 + b[9] * m2
    w = add_diag(a6 @ w1 + b[7] * a6 + b[5] * a4 + b[3] * a2, b[1])
    lw = m6 @ w1 + a6 @ lw1 + b[7] * m6 + b[5] * m4 + b[3] * m2
    u = a @ w
    lu = e @ w + a @ lw
    z1 = b[12] * a6 + b[10] * a4 + b[8] * a2
    lz1 = b[12] * m6 + b[10] * m4 + b[8] * m2
    v = add_diag(a6 @ z1 + b[6] * a6 + b[4] * a4 + b[2] * a2, b[0])
    lv = m6 @ z1 + a6 @ lz1 + b[6] * m6 + b[4] * m4 + b[2] * m2
    den = v - u
    x = jnp.linalg.solve(den, v + u)
    # differentiate (V-U) X = (V+U):  (V-U) L = (Lu+Lv) + (Lu-Lv) X
    ell = jnp.linalg.solve(den, lu + lv + (lu - lv) @ x)

    def cond(state):
        k, _, _ = state
        return jnp.any(k < s)

    def body(state):
        k, x, ell = state
        mask = (k < s)[..., None, None]
        ell = jnp.where(mask, x @ ell + ell @ x, ell)
        x = jnp.where(mask, x @ x, x)
        return k + 1, x, ell

    _, _, ell = lax.while_loop(
        cond, body, (jnp.zeros(batch_shape, jnp.int32), x, ell)
    )
    return ell


def _expm_fwd(a):
    return _expm_impl(a), a


def _expm_bwd(a, g):
    # adjoint identity: vjp(A, G) = L(A^T, G)  (Higham 2008, section 10.6)
    return (_expm_frechet(jnp.swapaxes(a, -1, -2), g),)


expm_batch.defvjp(_expm_fwd, _expm_bwd)


def expm(a: jnp.ndarray) -> jnp.ndarray:
    """Matrix exponential of a single square matrix."""
    return expm_batch(a[None])[0]
