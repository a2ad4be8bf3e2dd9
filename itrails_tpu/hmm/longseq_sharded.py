"""Mesh-sharded sequence parallelism for chromosome-scale blocks.

``hmm.longseq`` makes ONE long block parallel over *chunks* on one chip; this
module shards those chunks over a ``jax.sharding.Mesh`` so a single block
spans every chip of a slice.  The cross-chip pattern is the classic
sequence-parallel prefix ladder: each device folds its local chunk transfer
operators into one per-shard (M, M) operator, one ``all_gather`` moves the
n_dev tiny operators everywhere, and every device closes its own
exclusive prefix/suffix locally (n_dev is static, M <= ~200, so the
cross-chip step is O(n_dev * M^2) FLOPs and one collective per direction).

The reference has no analogue at all — a chromosome-scale block is a single
serial numba loop on one core (reference optimizer.py:165-188); blocks are
its only parallel axis (optimizer.py:56-62).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from itrails_tpu.data.tokens import PAD_TOKEN
from itrails_tpu.hmm import longseq
from itrails_tpu.hmm.decoders import highest_precision
from itrails_tpu.hmm.longseq import _combine, chunk_operators

__all__ = ["sharded_forward_loglik_long", "sharded_forward_loglik_long_fn",
           "sharded_posterior_long", "sharded_viterbi_long",
           "sharded_viterbi_segmented"]


def _pad_stream(tokens, chunk: int, n_dev: int):
    """Split one (T,) token array into (first, (C, chunk) stream) with C a
    multiple of n_dev; pad columns are PAD_TOKEN (neutral)."""
    t_len = tokens.shape[0]
    stream_len = t_len - 1
    unit = chunk * n_dev
    padded = max(-(-stream_len // unit) * unit, unit)
    stream = jnp.concatenate(
        [tokens[1:], jnp.full((padded - stream_len,), PAD_TOKEN, tokens.dtype)]
    )
    return tokens[0], stream.reshape(-1, chunk)


def _norm(g):
    z = jnp.maximum(jnp.max(g, axis=(-2, -1), keepdims=True),
                    jnp.finfo(g.dtype).tiny)
    return g / z


def _vnorm(v):
    z = jnp.maximum(jnp.max(v, axis=-1, keepdims=True),
                    jnp.finfo(v.dtype).tiny)
    return v / z


@functools.lru_cache(maxsize=16)
def sharded_forward_loglik_long_fn(mesh: Mesh, chunk: int = 256):
    """Cached jitted kernel for :func:`sharded_forward_loglik_long`
    (build once per (mesh, chunk) so per-optimizer-eval calls reuse the
    compiled executable)."""
    n_dev = mesh.devices.size

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P("data", None)), out_specs=P(),
        check_vma=False,
    )
    @highest_precision
    def f(a, bfull, pi, first, tok):
        # local chunk operators, then an ordered local fold
        # f64 log-normalizer leg, as in longseq.forward_loglik_long
        ops, logz = chunk_operators(a, bfull, tok.reshape(-1), chunk)
        g_all, z_all = lax.associative_scan(
            _combine, (ops, logz.astype(jnp.float64)))
        g_loc, z_loc = g_all[-1], z_all[-1]
        # one collective: every device sees every shard's (M, M) operator
        g_sh = lax.all_gather(g_loc, "data")  # (n_dev, M, M)
        z_sh = lax.all_gather(z_loc, "data")  # (n_dev,)
        g, z = g_sh[0], z_sh[0]
        for k in range(1, n_dev):
            g, z = _combine((g, z), (g_sh[k], z_sh[k]))
        alpha0 = pi * bfull.T[jnp.maximum(first, 0)]
        return jnp.log(jnp.sum(alpha0 @ g)) + z

    return f


def sharded_forward_loglik_long(a, bfull, pi, tokens, mesh: Mesh,
                                chunk: int = 256):
    """Log-likelihood of ONE long (T,) token sequence, chunks sharded over
    the mesh.  Matches longseq.forward_loglik_long to fp tolerance."""
    n_dev = mesh.devices.size
    first, tok = _pad_stream(tokens, chunk, n_dev)
    tok = jax.device_put(tok, NamedSharding(mesh, P("data", None)))
    return sharded_forward_loglik_long_fn(mesh, chunk)(a, bfull, pi, first, tok)


def _alpha_beta_sharded(mesh: Mesh, n_dev: int, m: int):
    """shard_mapped kernel computing per-position (rescaled) alpha and beta
    vectors of one long block, chunks sharded over the mesh.

    Returns alphas[s] = alpha at global position s+1 and betas[s] = beta at
    global position s, both (C_local, chunk, M) per shard — the same row
    convention as longseq.posterior_long's recompute scans."""

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P("data", None)),
        out_specs=(P("data", None, None), P("data", None, None)),
        check_vma=False,
    )
    @highest_precision
    def f(a, bfull, pi, first, tok):
        c_loc = tok.shape[0]
        eye = jnp.eye(m, dtype=a.dtype)
        eye1 = jnp.broadcast_to(eye, (1, m, m))
        g0 = jnp.broadcast_to(eye, (c_loc, m, m))

        # ---- forward: local chunk operators G_c = prod (A diag(e)) ----
        def fwd_op_step(g, t_col):
            e = bfull.T[jnp.maximum(t_col, 0)]
            new = _norm((g @ a) * e[:, None, :])
            return jnp.where((t_col != PAD_TOKEN)[:, None, None], new, g), None

        ops, _ = lax.scan(fwd_op_step, g0, tok.T)
        prefix = lax.associative_scan(lambda l, r: _norm(l @ r), ops)
        prefix_ex = jnp.concatenate([eye1, prefix[:-1]], axis=0)

        # cross-shard exclusive prefix of the per-shard totals
        tot_f = lax.all_gather(prefix[-1], "data")  # (n_dev, M, M)
        alpha0 = pi * bfull.T[jnp.maximum(first, 0)]
        # v_k = alpha0 @ T_0 @ ... @ T_{k-1}; select this shard's k
        vs = [_vnorm(alpha0)]
        for k in range(1, n_dev):
            vs.append(_vnorm(vs[-1] @ tot_f[k - 1]))
        v_my = jnp.stack(vs)[lax.axis_index("data")]
        alpha_entry = _vnorm(jnp.einsum("m,cmn->cn", v_my, prefix_ex))

        # ---- backward: local chunk operators K_c = prod (A^T diag(e)) ----
        def bwd_op_step(g, t_col):
            e = bfull.T[jnp.maximum(t_col, 0)]
            new = _norm(g @ (a.T * e[:, None, :]))
            return jnp.where((t_col != PAD_TOKEN)[:, None, None], new, g), None

        kops, _ = lax.scan(bwd_op_step, g0, tok.T)
        suffix = lax.associative_scan(lambda l, r: _norm(r @ l), kops[::-1])[::-1]
        suffix_ex = jnp.concatenate([suffix[1:], eye1], axis=0)

        # cross-shard exclusive suffix: r_k = (T_{k+1} ... T_{n-1}) @ 1
        tot_b = lax.all_gather(suffix[0], "data")  # (n_dev, M, M)
        rs = [jnp.ones((m,), a.dtype)]
        for k in range(n_dev - 2, -1, -1):
            rs.append(_vnorm(tot_b[k + 1] @ rs[-1]))
        r_my = jnp.stack(rs[::-1])[lax.axis_index("data")]
        beta_exit = _vnorm(jnp.einsum("cmn,n->cm", suffix_ex, r_my))

        # ---- per-position recompute, batched over local chunks ----
        def fwd_step(alpha, t_col):
            e = bfull.T[jnp.maximum(t_col, 0)]
            new = _vnorm((alpha @ a) * e)
            alpha = jnp.where((t_col != PAD_TOKEN)[:, None], new, alpha)
            return alpha, alpha

        _, alphas = lax.scan(fwd_step, alpha_entry, tok.T)  # (chunk, Cl, M)

        def bwd_step(beta, t_col):
            e = bfull.T[jnp.maximum(t_col, 0)]
            new = _vnorm((beta * e) @ a)
            beta = jnp.where((t_col != PAD_TOKEN)[:, None], new, beta)
            return beta, beta

        _, betas_rev = lax.scan(bwd_step, beta_exit, tok.T[::-1])
        betas = betas_rev[::-1]
        return alphas.transpose(1, 0, 2), betas.transpose(1, 0, 2)

    return f


def sharded_posterior_long(a, bfull, pi, tokens, mesh: Mesh,
                           chunk: int = 256):
    """Exact posterior (T, M) of ONE long block, chunks sharded over the
    mesh (matches longseq.posterior_long / decoders.posterior to fp
    tolerance).

    Device side computes per-position rescaled alpha/beta vectors
    (sequence-parallel, one all_gather per direction); the host aligns the
    rows — gamma_p pairs alpha_p with beta_p, and the alpha rows are offset
    one stream position from the beta rows (longseq.posterior_long's
    assembly) — and takes the scale-cancelling softmax.
    """
    t_len = tokens.shape[0]
    m = a.shape[0]
    stream_len = t_len - 1
    n_dev = mesh.devices.size
    first, tok = _pad_stream(tokens, chunk, n_dev)
    tok_sh = jax.device_put(tok, NamedSharding(mesh, P("data", None)))

    alphas, betas = _alpha_beta_sharded(mesh, n_dev, m)(
        a, bfull, pi, first, tok_sh
    )
    alphas = np.asarray(alphas).reshape(-1, m)[:stream_len]
    betas = np.asarray(betas).reshape(-1, m)[:stream_len]

    alpha0 = np.asarray(pi) * np.asarray(bfull).T[max(int(tokens[0]), 0)]
    alpha_all = np.concatenate([alpha0[None], alphas], axis=0)
    beta_all = np.concatenate(
        [betas, np.ones((1, m), alpha_all.dtype)], axis=0
    )

    tiny = np.finfo(alpha_all.dtype).tiny
    post = np.log(np.maximum(alpha_all, tiny)) + np.log(
        np.maximum(beta_all, tiny)
    )
    post = post - post.max(axis=1, keepdims=True)
    post = np.exp(post)
    return post / post.sum(axis=1, keepdims=True)


def sharded_viterbi_long(a, bfull, pi, tokens, mesh: Mesh,
                         chunk: int = 256):
    """Exact Viterbi path of ONE long block, chunks sharded over the mesh
    (matches decoders.viterbi exactly, including first-index tie-breaking).

    Max-plus analogue of :func:`sharded_posterior_long`: per-shard chunk
    operators + local exclusive prefix, one ``all_gather`` of per-shard
    (M, M) max-plus totals, then a batched pointer-recording recursion.
    Backpointers come back shard-sharded; the backtrack runs on the host.
    For T beyond host memory use longseq.viterbi_segmented (single chip,
    bounded memory) — a sharded segmented variant is future work.
    """
    t_len = tokens.shape[0]
    m = a.shape[0]
    stream_len = t_len - 1
    n_dev = mesh.devices.size
    log_a = jnp.log(a)
    log_b = jnp.log(bfull.T)
    omega0 = jnp.log(pi) + log_b[jnp.maximum(tokens[0], 0)]
    if stream_len == 0:
        return np.asarray([int(jnp.argmax(omega0))], dtype=np.int32)

    first, tok = _pad_stream(tokens, chunk, n_dev)
    tok_sh = jax.device_put(tok, NamedSharding(mesh, P("data", None)))

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P("data", None)),
        out_specs=(P("data", None, None), P()), check_vma=False,
    )
    def f(log_a, log_b, omega0, tok):
        c_loc = tok.shape[0]
        neg = jnp.asarray(jnp.finfo(log_a.dtype).min / 4, log_a.dtype)
        ident = jnp.where(jnp.eye(m, dtype=bool), 0.0, neg).astype(log_a.dtype)
        g0 = jnp.broadcast_to(ident, (c_loc, m, m))

        def mp(l, r):
            return jnp.max(l[..., :, :, None] + r[..., None, :, :], axis=-2)

        def op_step(g, t_col):
            e = log_b[jnp.maximum(t_col, 0)]
            new = mp(g, log_a[None] + e[:, None, :])
            return jnp.where((t_col != PAD_TOKEN)[:, None, None], new, g), None

        ops, _ = lax.scan(op_step, g0, tok.T)
        prefix = lax.associative_scan(mp, ops)
        prefix_ex = jnp.concatenate([g0[:1], prefix[:-1]], axis=0)

        # cross-shard exclusive max-plus prefix of per-shard totals
        tot = lax.all_gather(prefix[-1], "data")  # (n_dev, M, M)
        vs = [omega0]
        for k in range(1, n_dev):
            vs.append(jnp.max(vs[-1][:, None] + tot[k - 1], axis=0))
        v_my = jnp.stack(vs)[lax.axis_index("data")]
        omega_entry = jnp.max(v_my[None, :, None] + prefix_ex, axis=1)

        def rec_step(omega, t_col):
            e = log_b[jnp.maximum(t_col, 0)]
            scores = omega[:, :, None] + log_a[None] + e[:, None, :]
            ptr = jnp.argmax(scores, axis=1).astype(jnp.int32)
            new = jnp.max(scores, axis=1)
            pad = (t_col == PAD_TOKEN)[:, None]
            idn = jnp.broadcast_to(
                jnp.arange(m, dtype=jnp.int32)[None, :], ptr.shape
            )
            return (jnp.where(pad, omega, new),
                    (jnp.where(pad, idn, ptr), jnp.where(pad, omega, new)))

        omega_last, (ptrs, _) = lax.scan(rec_step, omega_entry, tok.T)
        # final omega: the LAST shard's last chunk (shards later than this
        # one are identity only on the final shard); psum-style max merge
        # is wrong for ordered products, so gather and let the host pick —
        # simplest exact route: every shard contributes its last omega and
        # the host uses the final shard's.
        omega_fin = lax.all_gather(omega_last[-1], "data")[-1]
        return ptrs.transpose(1, 0, 2), omega_fin

    ptrs, omega_fin = f(log_a, log_b, omega0, tok_sh)
    ptrs = np.asarray(ptrs).reshape(-1, m)[:stream_len]
    path = np.empty(t_len, dtype=np.int32)
    path[-1] = int(np.argmax(np.asarray(omega_fin)))
    path[:stream_len] = longseq._backtrack_walk(ptrs, path[-1])
    return path


# ---------------------------------------------------------------------------
# Sharded segmented Viterbi: bounded memory (longseq.viterbi_segmented) with
# the per-segment max-plus operator computation sharded over the mesh.
# ---------------------------------------------------------------------------


def _mp(l, r):
    """(max, +) semiring matrix product, batched over leading dims."""
    return jnp.max(l[..., :, :, None] + r[..., None, :, :], axis=-2)


@functools.lru_cache(maxsize=16)
def _seg_exit_fn(mesh: Mesh, m: int):
    """shard_mapped kernel: omega vector after one segment whose chunks are
    sharded over the mesh (collective: one all_gather of per-shard (M, M)
    max-plus totals)."""
    n_dev = mesh.devices.size

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P("data", None)), out_specs=P(),
        check_vma=False,
    )
    def f(log_a, log_b, omega_in, tok):
        c_loc = tok.shape[0]
        neg = jnp.asarray(jnp.finfo(log_a.dtype).min / 4, log_a.dtype)
        ident = jnp.where(jnp.eye(m, dtype=bool), 0.0, neg).astype(log_a.dtype)
        g0 = jnp.broadcast_to(ident, (c_loc, m, m))

        def op_step(g, t_col):
            e = log_b[jnp.maximum(t_col, 0)]
            new = _mp(g, log_a[None] + e[:, None, :])
            return jnp.where((t_col != PAD_TOKEN)[:, None, None], new, g), None

        ops, _ = lax.scan(op_step, g0, tok.T)
        loc = lax.associative_scan(_mp, ops)[-1]  # local ordered total
        tot = lax.all_gather(loc, "data")  # (n_dev, M, M)
        g = tot[0]
        for k in range(1, n_dev):
            g = _mp(g, tot[k])
        return jnp.max(omega_in[:, None] + g, axis=0)

    return f


@functools.lru_cache(maxsize=16)
def _seg_ptrs_fn(mesh: Mesh, m: int):
    """shard_mapped kernel: backpointer table of one segment given its entry
    omega; chunks sharded, the cross-shard exclusive max-plus prefix closed
    locally after one all_gather."""
    n_dev = mesh.devices.size

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P("data", None)),
        out_specs=P("data", None, None), check_vma=False,
    )
    def f(log_a, log_b, omega_in, tok):
        c_loc = tok.shape[0]
        neg = jnp.asarray(jnp.finfo(log_a.dtype).min / 4, log_a.dtype)
        ident = jnp.where(jnp.eye(m, dtype=bool), 0.0, neg).astype(log_a.dtype)
        g0 = jnp.broadcast_to(ident, (c_loc, m, m))

        def op_step(g, t_col):
            e = log_b[jnp.maximum(t_col, 0)]
            new = _mp(g, log_a[None] + e[:, None, :])
            return jnp.where((t_col != PAD_TOKEN)[:, None, None], new, g), None

        ops, _ = lax.scan(op_step, g0, tok.T)
        prefix = lax.associative_scan(_mp, ops)
        prefix_ex = jnp.concatenate([g0[:1], prefix[:-1]], axis=0)

        tot = lax.all_gather(prefix[-1], "data")  # (n_dev, M, M)
        vs = [omega_in]
        for k in range(1, n_dev):
            vs.append(jnp.max(vs[-1][:, None] + tot[k - 1], axis=0))
        v_my = jnp.stack(vs)[lax.axis_index("data")]
        omega_entry = jnp.max(v_my[None, :, None] + prefix_ex, axis=1)

        def rec_step(omega, t_col):
            e = log_b[jnp.maximum(t_col, 0)]
            scores = omega[:, :, None] + log_a[None] + e[:, None, :]
            ptr = jnp.argmax(scores, axis=1).astype(jnp.int32)
            new = jnp.max(scores, axis=1)
            pad = (t_col == PAD_TOKEN)[:, None]
            idn = jnp.broadcast_to(
                jnp.arange(m, dtype=jnp.int32)[None, :], ptr.shape
            )
            return jnp.where(pad, omega, new), jnp.where(pad, idn, ptr)

        _, ptrs = lax.scan(rec_step, omega_entry, tok.T)
        return ptrs.transpose(1, 0, 2)  # (C_local, chunk, M)

    return f


def sharded_viterbi_segmented(a, bfull, pi, tokens, mesh: Mesh,
                              chunk: int = 256, seg_chunks: int = 512):
    """Exact Viterbi path of ONE chromosome-scale block with BOUNDED memory,
    the per-segment operator computation sharded over the mesh.

    Combines longseq.viterbi_segmented (checkpoint entry omegas per segment
    of ``seg_chunks * chunk`` columns, recompute backpointers one segment at
    a time in the reverse sweep) with sharded_viterbi_long's cross-chip
    prefix ladder, so T ~ 1e8 decodes use every chip of the slice while
    peak memory stays O(seg_chunks * chunk * M) per direction.  Matches
    decoders.viterbi exactly (first-index tie-breaking).  The reference has
    no analogue (one serial numba loop per block, optimizer.py:305-354).
    """
    t_len = tokens.shape[0]
    m = a.shape[0]
    n_dev = mesh.devices.size
    log_a = jnp.log(a)
    log_b = jnp.log(bfull.T)
    omega0 = jnp.log(pi) + log_b[jnp.maximum(tokens[0], 0)]
    stream_len = t_len - 1
    if stream_len == 0:
        return np.asarray([int(jnp.argmax(omega0))], dtype=np.int32)

    # segment layout: every segment holds seg_chunks*chunk columns with
    # seg_chunks a multiple of n_dev (pad chunks are identity)
    seg_chunks = max(-(-seg_chunks // n_dev) * n_dev, n_dev)
    seg_cols = seg_chunks * chunk
    n_seg = max(-(-stream_len // seg_cols), 1)
    padded = n_seg * seg_cols
    stream = jnp.concatenate(
        [tokens[1:], jnp.full((padded - stream_len,), PAD_TOKEN, tokens.dtype)]
    )
    segs = np.asarray(stream).reshape(n_seg, seg_chunks, chunk)
    sh = NamedSharding(mesh, P("data", None))

    exit_fn = _seg_exit_fn(mesh, m)
    ptrs_fn = _seg_ptrs_fn(mesh, m)

    entries = [omega0]
    for s in range(n_seg):
        tok_s = jax.device_put(jnp.asarray(segs[s]), sh)
        entries.append(exit_fn(log_a, log_b, entries[-1], tok_s))
    final_omega = np.asarray(entries[-1])

    path = np.empty(t_len, dtype=np.int32)
    state = int(np.argmax(final_omega))
    path[-1] = state
    for s in range(n_seg - 1, -1, -1):
        tok_s = jax.device_put(jnp.asarray(segs[s]), sh)
        ptrs = np.asarray(ptrs_fn(log_a, log_b, entries[s], tok_s))
        ptrs = ptrs.reshape(-1, m)  # segment stream order
        lo = s * seg_cols
        hi = min((s + 1) * seg_cols, stream_len)
        path[lo:hi] = longseq._backtrack_walk(ptrs[: hi - lo], state)
        state = path[lo]
    return path
