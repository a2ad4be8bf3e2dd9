"""Sequence-parallel forward pass for chromosome-scale blocks.

The HMM forward recurrence is sequential in the alignment position, so a
single long block cannot use the window-batch data parallelism of
``hmm.decoders`` (one window => one (1, M) matvec per column, latency-bound
per column).  The associative reformulation: the per-column update is
``alpha' = alpha @ (A diag(e_t))``, so any chunk of columns collapses into a
single M x M *transfer operator* — the ordered product of its per-column
operators — and chunk operators combine associatively.  This file computes

  1. all chunk operators in parallel (a scan of length ``chunk`` over
     batched (C, M, M) matmuls — the sequential depth drops from T to
     ``chunk``), with per-step rescaling into log-space to avoid underflow;
  2. their ordered product via ``lax.associative_scan`` (log2(C) rounds);
  3. the log-likelihood from ``(pi * e_0) @ P``.

This is the "ring/blocked-parallel" analogue for HMMs named in SURVEY.md
section 5: per-column state is tiny but T is huge, so we trade O(M) extra
flops per column for T/chunk-fold parallelism.  Results match the
sequential forward to ~1e-5 relative (different floating-point summation
order).  The ``chunk`` defaults below are not yet measured on the H100
(ROADMAP queue 1).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from itrails_tpu.data.tokens import PAD_TOKEN
from itrails_tpu.hmm.decoders import highest_precision

__all__ = ["forward_loglik_long", "forward_loglik_long_remat",
           "posterior_long", "chunk_operators", "viterbi_segmented"]


@highest_precision
def chunk_operators(a, bfull, tokens, chunk: int):
    """Per-chunk transfer operators for a 1-D token array whose length is a
    multiple of ``chunk`` (pad with PAD_TOKEN; pad columns are identity).

    Returns ``(ops, logscale)``: (C, M, M) rescaled operators and (C,)
    accumulated log scale factors.
    """
    m = a.shape[0]
    c = tokens.shape[0] // chunk
    tok = tokens.reshape(c, chunk)

    def step(carry, t_col):
        g, logz = carry  # g: (C, M, M)
        e = bfull.T[jnp.maximum(t_col, 0)]  # (C, M)
        new = (g @ a) * e[:, None, :]
        z = jnp.max(new, axis=(1, 2), keepdims=True)
        z = jnp.maximum(z, jnp.finfo(new.dtype).tiny)
        new = new / z
        valid = (t_col != PAD_TOKEN)[:, None, None]
        g = jnp.where(valid, new, g)
        logz = logz + jnp.where(valid[:, 0, 0], jnp.log(z[:, 0, 0]), 0.0)
        return (g, logz), None

    g0 = jnp.broadcast_to(jnp.eye(m, dtype=a.dtype), (c, m, m))
    logz0 = jnp.zeros((c,), a.dtype)
    (g, logz), _ = lax.scan(step, (g0, logz0), tok.T)
    return g, logz


def _combine(left, right):
    """Associative combine of rescaled transfer operators."""
    gl, zl = left
    gr, zr = right
    g = gl @ gr
    z = jnp.max(g, axis=(-2, -1), keepdims=True)
    z = jnp.maximum(z, jnp.finfo(g.dtype).tiny)
    return g / z, zl + zr + jnp.log(z[..., 0, 0])


@highest_precision
def posterior_long(a, bfull, pi, tokens, chunk: int = 256):
    """Exact posterior state probabilities for one long block, (T, M),
    sequence-parallel (matches decoders.posterior to fp tolerance).

    Strategy: chunk transfer operators in both directions over the "stream"
    (columns 1..T-1; column 0 enters through ``alpha_0 = pi * e_0``);
    exclusive prefix/suffix products give the alpha/beta vectors at chunk
    boundaries; per-position values are then recomputed *batched across
    chunks*, so the sequential depth is 2*chunk + O(log C).  The posterior's
    per-position softmax cancels all rescaling constants, so no log
    bookkeeping is needed.
    """
    t_len = tokens.shape[0]
    m = a.shape[0]
    first = tokens[0]
    stream_len = t_len - 1
    padded = max(((stream_len + chunk - 1) // chunk) * chunk, chunk)
    stream = jnp.concatenate(
        [tokens[1:], jnp.full((padded - stream_len,), PAD_TOKEN, tokens.dtype)]
    )
    c = padded // chunk
    tok = stream.reshape(c, chunk)
    eye1 = jnp.broadcast_to(jnp.eye(m, dtype=a.dtype), (1, m, m))

    def norm(g):
        z = jnp.maximum(jnp.max(g, axis=(-2, -1), keepdims=True),
                        jnp.finfo(g.dtype).tiny)
        return g / z

    # ---- forward chunk operators G_c = prod_k (A diag(e_k)), rescaled ----
    def fwd_op_step(g, t_col):
        e = bfull.T[jnp.maximum(t_col, 0)]
        new = norm((g @ a) * e[:, None, :])
        g = jnp.where((t_col != PAD_TOKEN)[:, None, None], new, g)
        return g, None

    g0 = jnp.broadcast_to(jnp.eye(m, dtype=a.dtype), (c, m, m))
    ops, _ = lax.scan(fwd_op_step, g0, tok.T)

    def comb(l, r):
        return norm(l @ r)

    prefix = lax.associative_scan(comb, ops)
    prefix_ex = jnp.concatenate([eye1, prefix[:-1]], axis=0)
    alpha0 = pi * bfull.T[jnp.maximum(first, 0)]
    alpha_entry = jnp.einsum("m,cmn->cn", alpha0, prefix_ex)  # (C, M)

    # ---- backward chunk operators K_c = prod_k (A^T diag(e_k)) ----
    # (column form of the reference's source-state backward contraction,
    # decoders.backward: beta_t = A^T D_{t+1} beta_{t+1})
    def bwd_op_step(g, t_col):
        e = bfull.T[jnp.maximum(t_col, 0)]
        new = norm(g @ (a.T * e[:, None, :]))
        g = jnp.where((t_col != PAD_TOKEN)[:, None, None], new, g)
        return g, None

    kops, _ = lax.scan(bwd_op_step, g0, tok.T)
    # suffix products S_c = K_c K_{c+1} ... K_{C-1}
    suffix = lax.associative_scan(lambda l, r: norm(r @ l), kops[::-1])[::-1]
    suffix_ex = jnp.concatenate([suffix[1:], eye1], axis=0)  # S_{c+1}
    ones = jnp.ones((m,), a.dtype)
    beta_exit = jnp.einsum("cmn,n->cm", suffix_ex, ones)  # (C, M)

    # ---- per-position recompute, batched over chunks ----
    def fwd_step(alpha, t_col):
        e = bfull.T[jnp.maximum(t_col, 0)]
        new = (alpha @ a) * e
        z = jnp.maximum(jnp.max(new, axis=1, keepdims=True),
                        jnp.finfo(new.dtype).tiny)
        new = new / z
        alpha = jnp.where((t_col != PAD_TOKEN)[:, None], new, alpha)
        return alpha, alpha

    _, alphas = lax.scan(fwd_step, alpha_entry, tok.T)  # (chunk, C, M)

    def bwd_step(beta, t_col):
        e = bfull.T[jnp.maximum(t_col, 0)]
        new = (beta * e) @ a
        z = jnp.maximum(jnp.max(new, axis=1, keepdims=True),
                        jnp.finfo(new.dtype).tiny)
        new = new / z
        beta = jnp.where((t_col != PAD_TOKEN)[:, None], new, beta)
        return beta, beta

    _, betas_rev = lax.scan(bwd_step, beta_exit, tok.T[::-1])
    betas = betas_rev[::-1]  # betas[k, c] = beta at position (c*chunk + k)

    # assemble: alpha rows for positions 1..; prepend alpha_0
    alpha_flat = alphas.transpose(1, 0, 2).reshape(-1, m)[: t_len - 1]
    alpha_all = jnp.concatenate([alpha0[None], alpha_flat], axis=0)
    # beta rows for positions 0..T-2; append beta_{T-1} = ones
    beta_flat = betas.transpose(1, 0, 2).reshape(-1, m)[: t_len - 1]
    beta_all = jnp.concatenate([beta_flat, jnp.ones((1, m), a.dtype)], axis=0)

    post = jnp.log(jnp.maximum(alpha_all, jnp.finfo(a.dtype).tiny)) + jnp.log(
        jnp.maximum(beta_all, jnp.finfo(a.dtype).tiny)
    )
    post = post - jnp.max(post, axis=1, keepdims=True)
    post = jnp.exp(post)
    return post / jnp.sum(post, axis=1, keepdims=True)


@highest_precision
def forward_loglik_long(a, bfull, pi, tokens, chunk: int = 256):
    """Log-likelihood of one long token sequence, sequence-parallel.

    ``tokens``: (T,) int array; internally right-padded to a multiple of
    ``chunk`` (padding is neutral).
    """
    t_len = tokens.shape[0]
    padded = ((t_len - 1 + chunk - 1) // chunk) * chunk
    first = tokens[0]
    rest = tokens[1:]
    rest = jnp.concatenate(
        [rest, jnp.full((padded - (t_len - 1),), PAD_TOKEN, tokens.dtype)]
    )
    ops, logz = chunk_operators(a, bfull, rest, chunk)
    # ordered product of all chunk operators (prefix scan, take the last).
    # The log-normalizer leg accumulates in f64 (no-op without x64): a
    # chromosome-scale block reaches |logz| ~ 1e8 nats, where f32 adds
    # quantize at ~8 nats — coarse enough to flatten optimizer steps.
    g_all, z_all = lax.associative_scan(
        _combine, (ops, logz.astype(jnp.float64)))
    g = g_all[-1]
    z = z_all[-1]
    alpha0 = pi * bfull.T[jnp.maximum(first, 0)]
    total = jnp.sum(alpha0 @ g)
    return jnp.log(total) + z


@highest_precision
def forward_loglik_long_remat(a, bfull, pi, tokens, chunk: int = 512,
                              seg_chunks: int = 64, inner: int = 32):
    """Reverse-differentiable sequence-parallel log-likelihood of one long
    block, with BOUNDED gradient memory (matches forward_loglik_long).

    Structure: an outer scan over segments of ``seg_chunks * chunk``
    columns whose carry is just the rescaled (M,) alpha vector; the segment
    body (checkpointed) computes its chunk transfer operators with a nested
    inner checkpoint every ``inner`` columns.  Reverse-mode memory is
    O(n_seg*M + (chunk/inner + inner)*seg_chunks*M^2) regardless of T —
    the scan-of-checkpointed-scans analogue of hmm.grad.forward_loglik_remat
    for the operator formulation.
    """
    t_len = tokens.shape[0]
    m = a.shape[0]
    first = tokens[0]
    alpha0 = pi * bfull.T[jnp.maximum(first, 0)]
    s0 = jnp.maximum(jnp.sum(alpha0), jnp.finfo(a.dtype).tiny)
    # f64 outer log-normalizer carry (see forward_loglik_long)
    carry0 = (alpha0 / s0, jnp.log(s0).astype(jnp.float64))

    stream_len = t_len - 1
    if stream_len == 0:
        al, logz = carry0
        return jnp.log(jnp.sum(al)) + logz
    seg_cols = seg_chunks * chunk
    n_seg = max(-(-stream_len // seg_cols), 1)
    padded = n_seg * seg_cols
    stream = jnp.concatenate(
        [tokens[1:], jnp.full((padded - stream_len,), PAD_TOKEN, tokens.dtype)]
    )
    # (n_seg, chunk/inner, inner, seg_chunks): column-major over each
    # chunk's time axis, chunks on the trailing (batch) axis
    segs = stream.reshape(n_seg, seg_chunks, chunk // inner, inner)
    segs = segs.transpose(0, 2, 3, 1)

    def col_step(g, t_col):
        e = bfull.T[jnp.maximum(t_col, 0)]  # (seg_chunks, M)
        new = (g @ a) * e[:, None, :]
        z = jnp.maximum(jnp.max(new, axis=(1, 2), keepdims=True),
                        jnp.finfo(new.dtype).tiny)
        valid = (t_col != PAD_TOKEN)[:, None, None]
        return jnp.where(valid, new / z, g), jnp.where(
            valid[:, 0, 0], jnp.log(z[:, 0, 0]), 0.0)

    @functools.partial(jax.checkpoint, prevent_cse=False)
    def inner_body(carry, cols):  # cols: (inner, seg_chunks)
        g, logz = carry

        def step(c, t_col):
            g, lz = c
            g, dlz = col_step(g, t_col)
            return (g, lz + dlz), None

        return lax.scan(step, (g, logz), cols)[0], None

    @functools.partial(jax.checkpoint, prevent_cse=False)
    def seg_body(carry, seg_tok):  # seg_tok: (chunk/inner, inner, seg_chunks)
        al, logz = carry
        g0 = jnp.broadcast_to(jnp.eye(m, dtype=a.dtype),
                              (seg_chunks, m, m))
        lz0 = jnp.zeros((seg_chunks,), a.dtype)
        (ops, lz), _ = lax.scan(inner_body, (g0, lz0), seg_tok)
        g_all, z_all = lax.associative_scan(_combine, (ops, lz))
        nx = al @ g_all[-1]
        s = jnp.maximum(jnp.sum(nx), jnp.finfo(a.dtype).tiny)
        return (nx / s, logz + z_all[-1] + jnp.log(s)), None

    (al, logz), _ = lax.scan(seg_body, carry0, segs)
    return jnp.log(jnp.maximum(jnp.sum(al), jnp.finfo(a.dtype).tiny)) + logz


def _backtrack_walk(ptrs, state):
    """Walk a (n, M) backpointer table from ``state`` (the state at
    position n); returns the (n,) int32 state sequence.  Native C at
    memory speed when a compiler is available (native/backtrack.cpp —
    ~1e8 dependent loads instead of 1e8 Python iterations), else the
    serial Python loop."""
    import numpy as np

    from itrails_tpu import native

    if native.backtrack_available():
        return native.viterbi_backtrack_native(ptrs, state)
    n = ptrs.shape[0]
    out = np.empty(n, dtype=np.int32)
    for t in range(n - 1, -1, -1):
        state = ptrs[t][state]
        out[t] = state
    return out


def viterbi_long(a, bfull, pi, tokens, chunk: int = 256):
    """Exact Viterbi path for one long block, sequence-parallel.

    Same chunked structure as :func:`posterior_long` in the (max, +)
    semiring: chunk operators R_c[i,j] = max over within-chunk paths of the
    summed log scores, combined with a max-plus associative scan; per-chunk
    omega vectors are then recomputed batched across chunks while recording
    backpointers, and the backtrack runs on the host.  Matches
    decoders.viterbi exactly (same argmax tie-breaking: first index wins).

    Memory: the (T, M) int32 backpointer table lives on device; for
    chromosome-scale T split the sequence into segments first.
    """
    import numpy as np

    t_len = tokens.shape[0]
    m = a.shape[0]
    neg = jnp.asarray(jnp.finfo(a.dtype).min / 4, a.dtype)
    log_a = jnp.log(a)
    log_b = jnp.log(bfull.T)

    first = tokens[0]
    stream_len = t_len - 1
    padded = max(((stream_len + chunk - 1) // chunk) * chunk, chunk)
    stream = jnp.concatenate(
        [tokens[1:], jnp.full((padded - stream_len,), PAD_TOKEN, tokens.dtype)]
    )
    c = padded // chunk
    tok = stream.reshape(c, chunk)

    def mp_matmul(l, r):
        # max-plus product, batched: out[., i, j] = max_k l[., i, k] + r[., k, j]
        return jnp.max(l[..., :, :, None] + r[..., None, :, :], axis=-2)

    def op_step(g, t_col):
        e = log_b[jnp.maximum(t_col, 0)]  # (C, M)
        step_op = log_a[None] + e[:, None, :]
        new = mp_matmul(g, step_op)
        return jnp.where((t_col != PAD_TOKEN)[:, None, None], new, g), None

    g0 = jnp.broadcast_to(
        jnp.where(jnp.eye(m, dtype=bool), 0.0, neg).astype(a.dtype), (c, m, m)
    )
    ops, _ = lax.scan(op_step, g0, tok.T)
    prefix = lax.associative_scan(mp_matmul, ops)
    prefix_ex = jnp.concatenate([g0[:1], prefix[:-1]], axis=0)
    omega0 = jnp.log(pi) + log_b[jnp.maximum(first, 0)]
    omega_entry = jnp.max(omega0[None, :, None] + prefix_ex, axis=1)  # (C, M)

    def rec_step(omega, t_col):
        e = log_b[jnp.maximum(t_col, 0)]
        # pre-emission argmax: keeps f32 tie-breaks bit-identical to
        # decoders.viterbi and the fused kernels (see decoders.viterbi)
        scores = omega[:, :, None] + log_a[None]
        ptr = jnp.argmax(scores, axis=1).astype(jnp.int32)
        new = jnp.max(scores, axis=1) + e
        pad = (t_col == PAD_TOKEN)[:, None]
        ident = jnp.broadcast_to(jnp.arange(m, dtype=jnp.int32)[None, :], ptr.shape)
        return (
            jnp.where(pad, omega, new),
            (jnp.where(pad, ident, ptr), jnp.where(pad, omega, new)),
        )

    omega_last, (ptrs, omegas) = lax.scan(rec_step, omega_entry, tok.T)
    # flatten to stream order: (T-1, M)
    ptrs = np.asarray(ptrs.transpose(1, 0, 2).reshape(-1, m)[:stream_len])
    omegas = np.asarray(omegas.transpose(1, 0, 2).reshape(-1, m)[:stream_len])

    final_omega = omegas[-1] if stream_len else np.asarray(omega0)
    path = np.empty(t_len, dtype=np.int32)
    path[-1] = int(np.argmax(final_omega))
    path[:stream_len] = _backtrack_walk(ptrs, path[-1])
    return path


def _mp_matmul(l, r):
    """(max, +) semiring matrix product, batched over leading dims."""
    return jnp.max(l[..., :, :, None] + r[..., None, :, :], axis=-2)


@functools.partial(jax.jit, static_argnames=("chunk",))
def _viterbi_seg_exit(log_a, log_b, omega_in, tok, *, chunk: int):
    """Max-plus omega vector after consuming one segment of stream columns.

    tok: (C, chunk) segment tokens (PAD-padded columns are identity).
    """
    m = log_a.shape[0]
    c = tok.shape[0]
    neg = jnp.asarray(jnp.finfo(log_a.dtype).min / 4, log_a.dtype)
    g0 = jnp.broadcast_to(
        jnp.where(jnp.eye(m, dtype=bool), 0.0, neg).astype(log_a.dtype),
        (c, m, m),
    )

    def op_step(g, t_col):
        e = log_b[jnp.maximum(t_col, 0)]
        new = _mp_matmul(g, log_a[None] + e[:, None, :])
        return jnp.where((t_col != PAD_TOKEN)[:, None, None], new, g), None

    ops, _ = lax.scan(op_step, g0, tok.T)
    total = lax.associative_scan(_mp_matmul, ops)[-1]
    return jnp.max(omega_in[:, None] + total, axis=0)


@functools.partial(jax.jit, static_argnames=("chunk",))
def _viterbi_seg_ptrs(log_a, log_b, omega_in, tok, *, chunk: int):
    """Backpointer table (chunk, C, M) for one segment, given the max-plus
    omega vector at the segment's entry."""
    m = log_a.shape[0]
    c = tok.shape[0]
    neg = jnp.asarray(jnp.finfo(log_a.dtype).min / 4, log_a.dtype)
    g0 = jnp.broadcast_to(
        jnp.where(jnp.eye(m, dtype=bool), 0.0, neg).astype(log_a.dtype),
        (c, m, m),
    )

    def op_step(g, t_col):
        e = log_b[jnp.maximum(t_col, 0)]
        new = _mp_matmul(g, log_a[None] + e[:, None, :])
        return jnp.where((t_col != PAD_TOKEN)[:, None, None], new, g), None

    ops, _ = lax.scan(op_step, g0, tok.T)
    prefix = lax.associative_scan(_mp_matmul, ops)
    prefix_ex = jnp.concatenate([g0[:1], prefix[:-1]], axis=0)
    omega_entry = jnp.max(omega_in[None, :, None] + prefix_ex, axis=1)

    def rec_step(omega, t_col):
        e = log_b[jnp.maximum(t_col, 0)]
        # pre-emission argmax: keeps f32 tie-breaks bit-identical to
        # decoders.viterbi and the fused kernels (see decoders.viterbi)
        scores = omega[:, :, None] + log_a[None]
        ptr = jnp.argmax(scores, axis=1).astype(jnp.int32)
        new = jnp.max(scores, axis=1) + e
        pad = (t_col == PAD_TOKEN)[:, None]
        ident = jnp.broadcast_to(
            jnp.arange(m, dtype=jnp.int32)[None, :], ptr.shape
        )
        return jnp.where(pad, omega, new), jnp.where(pad, ident, ptr)

    _, ptrs = lax.scan(rec_step, omega_entry, tok.T)
    return ptrs  # (chunk, C, M)


def viterbi_segmented(a, bfull, pi, tokens, chunk: int = 256,
                      seg_chunks: int = 512):
    """Exact Viterbi path for one long block with BOUNDED memory.

    :func:`viterbi_long` materialises the full (T, M) backpointer table; at
    chromosome scale (T ~ 1e8, M = 133) that is tens of GB.  This variant
    streams it in segments of ``seg_chunks * chunk`` columns: a forward pass
    keeps only the (M,) max-plus omega vector at each segment boundary
    (n_seg * M floats), then a reverse pass recomputes one segment's
    backpointers at a time on device and backtracks it on the host.  Peak
    memory is O(seg_chunks * chunk * M) regardless of T; compute is 2x the
    single-pass recursion (the classic checkpoint/recompute trade, same as
    jax.checkpoint for the decode).  Matches decoders.viterbi exactly.
    """
    import numpy as np

    t_len = tokens.shape[0]
    m = a.shape[0]
    log_a = jnp.log(a)
    log_b = jnp.log(bfull.T)
    omega0 = jnp.log(pi) + log_b[jnp.maximum(tokens[0], 0)]

    stream_len = t_len - 1
    if stream_len == 0:
        return np.asarray([int(jnp.argmax(omega0))], dtype=np.int32)

    seg_cols = seg_chunks * chunk
    n_seg = max(-(-stream_len // seg_cols), 1)
    padded = n_seg * seg_cols
    stream = jnp.concatenate(
        [tokens[1:], jnp.full((padded - stream_len,), PAD_TOKEN, tokens.dtype)]
    )
    segs = stream.reshape(n_seg, seg_chunks, chunk)

    # forward: omega vector at each segment entry (tiny: n_seg x M)
    entries = [omega0]
    for s in range(n_seg):
        entries.append(
            _viterbi_seg_exit(log_a, log_b, entries[-1], segs[s], chunk=chunk)
        )
    final_omega = np.asarray(entries[-1])

    # reverse: recompute one segment's pointers at a time, backtrack on host
    path = np.empty(t_len, dtype=np.int32)
    state = int(np.argmax(final_omega))
    path[-1] = state
    for s in range(n_seg - 1, -1, -1):
        ptrs = np.asarray(
            _viterbi_seg_ptrs(log_a, log_b, entries[s], segs[s], chunk=chunk)
        )  # (chunk, seg_chunks, M)
        ptrs = ptrs.transpose(1, 0, 2).reshape(-1, m)  # segment stream order
        lo = s * seg_cols
        hi = min((s + 1) * seg_cols, stream_len)
        # device-recomputed segment table, memory-speed native walk
        path[lo:hi] = _backtrack_walk(ptrs[: hi - lo], state)
        state = path[lo]
    return path
