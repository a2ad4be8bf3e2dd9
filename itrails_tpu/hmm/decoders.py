"""Scan-based HMM decoders: forward, backward, posterior, Viterbi.

The reference implements these as numba loops over one sequence at a time
(optimizer.py:145-354) and parallelises across alignment blocks with joblib
process pools.  Here each decoder is a ``lax.scan`` whose per-step state is a
(batch, M) matrix, so a whole batch of windows advances with one (W, M) @
(M, M) matmul per alignment column; batching over windows is the
data-parallel axis that shards across devices (see hmm.sharding).

Numerics mirror the reference exactly: log-space alpha/beta with a per-step
max shift (optimizer.py:165-188, 191-213), posterior = row-softmax(alpha +
beta) (:216-238), Viterbi = max-plus recursion with backpointer matrix and
reverse backtrack (:305-354).

Padding: windows are right-padded with ``PAD_TOKEN``; padded steps carry
state through unchanged so every quantity equals the unpadded computation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from itrails_tpu.data.tokens import PAD_TOKEN
from itrails_tpu.hmm import triton_hmm

__all__ = [
    "emission_table",
    "emission_table_new_method",
    "forward",
    "forward_loglik",
    "forward_loglik_fast",
    "backward",
    "highest_precision",
    "posterior",
    "viterbi",
]


def highest_precision(fn):
    """Trace ``fn`` with every matrix product at full f32 precision: on the
    GPU an unpinned f32 product may run in TF32, which keeps ~3 decimal
    digits."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


@highest_precision
def emission_table(b, agg):
    """(M, 625) emission table over the full (ambiguity-resolved) alphabet:
    ``b @ agg.T`` where agg is data.tokens.aggregation_matrix()."""
    return b @ jnp.asarray(agg, b.dtype).T


@highest_precision
def emission_table_new_method(b, pad_to: int | None = None):
    """(M, 125) emission table over the 3-species ("new method") alphabet:
    the (M, 256) four-species emission matrix marginalized over the
    outgroup nucleotide, then ambiguity-resolved (reference
    read_data.py:27-43 + optimizer.py:68-91 — present but broken there;
    a working decode path here via the CLIs' ``--obs-mode new-method``).
    Every decoder in this module accepts it directly with
    maf.maf_tokens_new_method tokens.  ``pad_to=625`` zero-pads the
    columns to the standard table width so every decoder, the kernels of
    hmm.triton_hmm included, sees one shape — tokens only ever index
    0..124, and PAD_TOKEN handling never reads the table."""
    from itrails_tpu.data.tokens import aggregation_matrix_3

    m = b.shape[0]
    b3 = b.reshape(m, 64, 4).sum(-1)
    out = b3 @ jnp.asarray(aggregation_matrix_3(), b.dtype).T
    if pad_to is not None and pad_to > out.shape[1]:
        out = jnp.concatenate(
            [out, jnp.zeros((m, pad_to - out.shape[1]), out.dtype)], axis=1
        )
    return out


def _gather_emis(bfull, tokens):
    """Per-step emission rows for a (W,) token vector -> (W, M); padded
    positions get all-ones (no-op)."""
    safe = jnp.maximum(tokens, 0)
    e = bfull.T[safe]  # (W, M)
    return jnp.where((tokens == PAD_TOKEN)[:, None], jnp.ones_like(e), e)


@highest_precision
def forward(a, bfull, pi, tokens):
    """Log-space forward pass over a (W, T) token batch.

    Returns ``(alpha_T, logliks)``: the final (W, M) log state vector and the
    per-window log-likelihoods (W,).
    """
    w = tokens.shape[0]
    alpha0 = jnp.log(pi[None, :] * _gather_emis(bfull, tokens[:, 0]))

    def step(alpha, tok):
        x = jnp.max(alpha, axis=1, keepdims=True)
        e = _gather_emis(bfull, tok)
        new = jnp.log((jnp.exp(alpha - x) @ a) * e) + x
        new = jnp.where((tok == PAD_TOKEN)[:, None], alpha, new)
        return new, None

    alpha, _ = lax.scan(step, alpha0, tokens[:, 1:].T)
    x = jnp.max(alpha, axis=1)
    loglik = jnp.log(jnp.sum(jnp.exp(alpha - x[:, None]), axis=1)) + x
    return alpha, loglik


def forward_loglik(a, bfull, pi, tokens):
    """Total log-likelihood of a (W, T) token batch (sum over windows)."""
    _, ll = forward(a, bfull, pi, tokens)
    return jnp.sum(ll)


def forward_loglik_fast(a, bfull, pi, tokens):
    """Total log-likelihood of a (W, T) token batch: the one dispatcher for
    the forward value.  A float32 request compiled for a CUDA device runs
    the Pallas-Triton kernel (hmm.triton_hmm); every other request runs the
    XLA scan.  The choice follows the platform the computation is compiled
    for (``lax.platform_dependent``), so a CPU-placed decode in a GPU
    process still gets the scan.  Float64 requests run the scan in float64:
    the Triton route accumulates its products in float32.  Per-window values
    are summed in float64 when x64 is on."""
    if bfull.dtype != jnp.float32:
        return triton_hmm.total(forward(a, bfull, pi, tokens)[1])
    return lax.platform_dependent(
        a, bfull, pi, tokens,
        cuda=triton_hmm.forward_loglik,
        default=lambda *x: triton_hmm.total(forward(*x)[1]),
    )


@highest_precision
def _forward_all(a, bfull, pi, tokens):
    """Forward pass keeping every step's alpha: (T, W, M)."""
    alpha0 = jnp.log(pi[None, :] * _gather_emis(bfull, tokens[:, 0]))

    def step(alpha, tok):
        x = jnp.max(alpha, axis=1, keepdims=True)
        e = _gather_emis(bfull, tok)
        new = jnp.log((jnp.exp(alpha - x) @ a) * e) + x
        new = jnp.where((tok == PAD_TOKEN)[:, None], alpha, new)
        return new, new

    _, rest = lax.scan(step, alpha0, tokens[:, 1:].T)
    return jnp.concatenate([alpha0[None], rest], axis=0)


@highest_precision
def backward(a, bfull, tokens):
    """Log-space backward pass; returns (T, W, M) beta values."""
    t_len = tokens.shape[1]
    beta_last = jnp.zeros((tokens.shape[0], a.shape[0]), bfull.dtype)

    def step(beta, tok):
        x = jnp.max(beta, axis=1, keepdims=True)
        e = _gather_emis(bfull, tok)
        # NOTE: `@ a` (not `@ a.T`) reproduces the reference recursion
        # (optimizer.py:210), which contracts over the *source* state.  The
        # textbook backward would use a.T; we mirror the reference because
        # its posteriors are the parity target (the joint matrix is
        # exchange-symmetric, so the difference is a per-state pi reweight).
        new = jnp.log((jnp.exp(beta - x) * e) @ a) + x
        new = jnp.where((tok == PAD_TOKEN)[:, None], beta, new)
        return new, new

    _, rest = lax.scan(step, beta_last, tokens[:, 1:].T[::-1])
    return jnp.concatenate([rest[::-1], beta_last[None]], axis=0)


def posterior(a, bfull, pi, tokens):
    """Posterior state probabilities, (T, W, M); padded steps are garbage
    (mask with ``tokens != PAD_TOKEN``)."""
    alpha = _forward_all(a, bfull, pi, tokens)
    beta = backward(a, bfull, tokens)
    post = alpha + beta
    post -= jnp.max(post, axis=2, keepdims=True)
    post = jnp.exp(post)
    return post / jnp.sum(post, axis=2, keepdims=True)


def viterbi(a, bfull, pi, tokens):
    """Most-probable state path per window: (W, T) int32.

    Padded steps repeat the last real state; mask with
    ``tokens != PAD_TOKEN`` when consuming.

    Log-probabilities are clamped at -1e4 (never -inf), omega is
    rescaled by its per-window max every step (f32 stability for
    unbounded T), and the argmax runs over PRE-emission scores (the
    source-independent emission term cannot change the true argmax, and
    max_i fl(s_i) + e == max_i fl(s_i + e) by monotonicity).  In f64 on
    real models this is the reference max-plus recursion
    (optimizer.py:305-333) exactly: rescaling shifts
    all scores per window and never changes an argmax at real-model
    margins."""
    neg = jnp.asarray(-1e4, bfull.dtype)
    log_clip = lambda x: jnp.maximum(  # noqa: E731
        jnp.log(jnp.maximum(x, jnp.zeros_like(x))), neg
    )
    log_a = log_clip(a)
    logb = log_clip(bfull)

    def loge(tok):
        e = logb.T[jnp.maximum(tok, 0)]  # (W, M)
        return jnp.where((tok == PAD_TOKEN)[:, None], jnp.zeros_like(e), e)

    omega0 = log_clip(pi)[None, :] + loge(tokens[:, 0])
    omega0 = omega0 - jnp.max(omega0, axis=1, keepdims=True)

    def fwd(omega, tok):
        scores = omega[:, :, None] + log_a[None, :, :]
        ptr = jnp.argmax(scores, axis=1).astype(jnp.int32)  # (W, M)
        new = jnp.max(scores, axis=1) + loge(tok)
        new = new - jnp.max(new, axis=1, keepdims=True)
        pad = (tok == PAD_TOKEN)[:, None]
        new = jnp.where(pad, omega, new)
        # padded steps: identity backpointer
        ident = jnp.broadcast_to(
            jnp.arange(new.shape[1], dtype=jnp.int32)[None, :], ptr.shape
        )
        ptr = jnp.where(pad, ident, ptr)
        return new, ptr

    omega, ptrs = lax.scan(fwd, omega0, tokens[:, 1:].T)  # ptrs: (T-1, W, M)
    last = jnp.argmax(omega, axis=1).astype(jnp.int32)  # (W,)

    def back(state, ptr):
        prev = jnp.take_along_axis(ptr, state[:, None], axis=1)[:, 0]
        return prev, prev

    _, states_rev = lax.scan(back, last, ptrs[::-1])
    path = jnp.concatenate([states_rev[::-1], last[None]], axis=0)  # (T, W)
    return path.T
