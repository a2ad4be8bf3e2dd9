"""Pallas kernels (Triton route) for the HMM forward log-likelihood and its
gradient.

Why kernels: the XLA decoders (hmm.decoders.forward, hmm.grad) are a
``lax.scan`` over alignment columns.  Every column costs several kernel
launches and a (W, M) round trip through device memory, while the work per
column is tiny (M = 27-182).  These kernels keep the recursion state on chip
for a whole window:

* launch shape: one program per block of ``BW`` windows, the time loop
  inside the program (``lax.fori_loop``).  Programs share nothing, so they
  run in parallel and in any order;
* state tiles: the state axis is padded to a multiple of 32 and carried as a
  tuple of (BW, 32) register tiles.  The transition product walks the
  (Mp, Mp) matrix 32 x 32 tile by tile from L2, so no program ever holds the
  whole matrix (at M = 182 it is 144 KB in f32) and M = 133/182 pad only to
  160/192;
* emission rows are gathered by token index straight from the transposed
  (625, Mp) table, which stays resident in L2;
* every product is IEEE f32 (``allow_tf32=False``).

The recurrence is the Rabiner-scaled linear-space forward of
hmm.grad.forward_loglik_remat: alpha renormalised to sum 1 every step, the
log-norms accumulated per window.

The gradient follows the checkpoint/recompute scheme: the forward kernel
also stores the alpha carry at every time-chunk entry; the backward kernel
walks the chunks in reverse, recomputes the chunk's alphas from its
checkpoint into a per-program scratch, then sweeps backward with the scaled
beta carry.  The Baum-Welch statistics

    dL/da[i, j]       = sum_t u_i (e * beta)_j / Z_t
    dL/dbfull[j, v_t] = sum_t (u @ a)_j beta_j / Z_t
    Z_t = sum_j (u @ a)_j (e * beta)_j,   u = alpha-hat_{t-1}

are formed once per chunk as matrix products over the chunk's (t, window)
rows: ``U^T @ VZ`` for dA and ``onehot(tokens)^T @ WE`` for dbfull.  Each
program writes its own partial sums, which XLA adds afterwards, so the result
does not depend on the order in which programs run (no atomics).  The t = 0
column (pi and its emission) is handled on the XLA side.

Both kernels compute in float32.  hmm.decoders.forward_loglik_fast sends
every float32 forward request here; hmm.grad.loglik_and_grads sends the
float32 gradient only at widths up to ``GRADIENT_MAX_STATES``, since above
it XLA's autodiff of the scan measured faster on an H100 (PERF.md).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from itrails_tpu.data.tokens import PAD_TOKEN

__all__ = ["ACC_DTYPE", "GRADIENT_MAX_STATES", "forward_loglik",
           "forward_logliks",
           "loglik_and_grads", "BLOCK_W", "padded_states",
           "serves_gradient", "total"]

_K = 625  # alphabet size
_KP = 640  # alphabet padded to whole 32-wide tiles (one-hot columns)
_TILE = 32  # state-tile width
_ROWS = 64  # (t, window) rows per product in the per-chunk statistics
_TINY = 1e-30
# windows per program: tl.dot needs 16 rows, and 16 measured fastest at
# M = 27 on an H100 (32: +16%, 64: +79%; PERF.md)
BLOCK_W = 16
# per-window log-likelihood accumulator: float64 when x64 is on.  A window
# sums one log-norm per column; in float32 the rounding of a ~1e5-nat sum
# grows with the window's length (measured ~5e-6 relative over 300 kb).
ACC_DTYPE = jax.dtypes.canonicalize_dtype(jnp.float64)
# widest state axis the gradient kernel serves (two 32-wide tiles)
GRADIENT_MAX_STATES = 64


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def padded_states(m: int) -> int:
    """State axis padded to whole 32-wide tiles."""
    return _round_up(m, _TILE)


def serves_gradient(m: int) -> bool:
    """True when the gradient kernel serves M states."""
    return padded_states(m) <= GRADIENT_MAX_STATES


def _params(nt: int):
    return plgpu.CompilerParams(num_warps=4 if nt <= 2 else 8, num_stages=1)


def _tile(j: int):
    return pl.ds(j * _TILE, _TILE)


def _precision(nt: int, interpret: bool):
    """Product precision for ``nt`` state tiles.  Up to two tiles the
    products are IEEE f32 on the FMA units; from three tiles on, three TF32
    tensor-core passes (hi*hi + hi*lo + lo*hi), which measured ~2x faster
    at M = 133/182 on an H100 with the total log-likelihood within 5.1e-8
    relative of the f64 scan (PERF.md).  The interpreter has no TF32 and
    runs IEEE f32 throughout."""
    if nt <= 2 or interpret:
        return jax.lax.Precision.HIGHEST
    return jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3


def _times_a(x, a_ref, nt: int, prec):
    """(x @ a) as tiles: y_j = sum_i x_i @ a[i, j]."""
    return tuple(
        functools.reduce(
            jnp.add,
            [pl.dot(x[i], a_ref[_tile(i), _tile(j)], precision=prec)
             for i in range(nt)],
        )
        for j in range(nt)
    )


def _times_at(x, a_ref, nt: int, prec):
    """(x @ a.T) as tiles: y_i = sum_j x_j @ a[i, j].T."""
    return tuple(
        functools.reduce(
            jnp.add,
            [pl.dot(x[j], a_ref[_tile(i), _tile(j)], trans_b=True,
                    precision=prec)
             for j in range(nt)],
        )
        for i in range(nt)
    )


def _emis(bt_ref, tok, nt: int):
    """Emission rows of a (BW,) token vector as tiles; pad rows read row 0
    (callers mask them)."""
    safe = jnp.maximum(tok, 0)
    return tuple(bt_ref[safe, _tile(j)] for j in range(nt))


def _step(al, tok, a_ref, bt_ref, nt: int, prec):
    """One scaled forward step: (new alpha tiles, log-norm)."""
    pad = tok == PAD_TOKEN
    pre = _times_a(al, a_ref, nt, prec)
    e = _emis(bt_ref, tok, nt)
    nx = tuple(p * x for p, x in zip(pre, e))
    s = functools.reduce(jnp.add, [jnp.sum(x, axis=1) for x in nx])
    snz = jnp.where(pad, 1.0, s)
    new = tuple(jnp.where(pad[:, None], o, x / snz[:, None])
                for o, x in zip(al, nx))
    return new, jnp.where(pad, 0.0, jnp.log(snz))


def _fwd_kernel(tok_ref, al0_ref, acc0_ref, a_ref, bt_ref, ll_ref, *chk,
                nt: int, chunk_t: int, n_chunks: int, prec):
    chk_ref = chk[0] if chk else None
    al = tuple(al0_ref[:, _tile(j)] for j in range(nt))

    def chunk_body(c, carry):
        al, acc = carry
        if chk_ref is not None:
            for j in range(nt):
                chk_ref[c, :, _tile(j)] = al[j]

        def step(t, carry):
            al, acc = carry
            al, lg = _step(al, tok_ref[c * chunk_t + t, :], a_ref, bt_ref,
                           nt, prec)
            return al, acc + lg.astype(acc.dtype)

        return jax.lax.fori_loop(0, chunk_t, step, (al, acc))

    _, acc = jax.lax.fori_loop(0, n_chunks, chunk_body, (al, acc0_ref[:]))
    ll_ref[:] = acc


def _accumulate(dst_ref, lhs, rhs_ref, n_lhs: int, nt: int, n_rows: int,
                prec):
    """dst[i, j] += sum_r lhs(r, i).T @ rhs[r, j] over the chunk's rows,
    tile by tile (lhs(rows, i) -> (R, 32) tile).  The tile loops run in the
    kernel rather than unrolled, which keeps the compile short."""

    def tile_pair(i, j):
        cols = pl.ds(j * _TILE, _TILE)

        def body(r, acc):
            rows = pl.ds(r * _ROWS, _ROWS)
            return acc + pl.dot(lhs(rows, i), rhs_ref[rows, cols],
                                trans_a=True, precision=prec)

        acc = jax.lax.fori_loop(0, n_rows // _ROWS, body,
                                jnp.zeros((_TILE, _TILE), jnp.float32))
        dst = (pl.ds(i * _TILE, _TILE), cols)
        dst_ref[dst] = dst_ref[dst] + acc

    def row_tile(i, carry):
        def col_tile(j, carry):
            tile_pair(i, j)
            return carry

        return jax.lax.fori_loop(0, nt, col_tile, carry)

    jax.lax.fori_loop(0, n_lhs, row_tile, 0)


def _bwd_kernel(tok_ref, chk_ref, a_ref, bt_ref, da_in, db_in,
                da_ref, db_ref, bef_ref, u_ref, vz_ref, we_ref, tk_ref, *,
                nt: int, chunk_t: int, n_chunks: int, bw: int,
                interpret: bool):
    """Reverse sweep over the chunks of one window block.  u/vz/we/tk are
    this program's scratch rows (t * bw + window) for one chunk, written and
    read back by different threads: a barrier separates the passes (the
    interpreter runs one thread and has no barrier)."""
    del da_in, db_in  # aliased to da_ref/db_ref (zero-initialised)
    barrier = (lambda: None) if interpret else plgpu.debug_barrier
    prec = _precision(nt, interpret)
    n_rows = chunk_t * bw

    def chunk_body(k, be):
        c = n_chunks - 1 - k
        t0 = c * chunk_t

        # pass 1: recompute the chunk's pre-update alphas from the checkpoint
        def rec(t, al):
            rows = pl.ds(t * bw, bw)
            for j in range(nt):
                u_ref[rows, _tile(j)] = al[j]
            al, _ = _step(al, tok_ref[t0 + t, :], a_ref, bt_ref, nt, prec)
            return al

        jax.lax.fori_loop(
            0, chunk_t, rec,
            tuple(chk_ref[c, :, _tile(j)] for j in range(nt)),
        )
        barrier()

        # pass 2: reverse, storing the per-row statistics' factors
        def rev(kk, be):
            t = chunk_t - 1 - kk
            rows = pl.ds(t * bw, bw)
            tok = tok_ref[t0 + t, :]
            pad = tok == PAD_TOKEN
            live = 1.0 - pad.astype(jnp.float32)
            u = tuple(u_ref[rows, _tile(j)] for j in range(nt))
            atu = _times_a(u, a_ref, nt, prec)
            v = tuple(x * b for x, b in zip(_emis(bt_ref, tok, nt), be))
            z = functools.reduce(
                jnp.add, [jnp.sum(p * q, axis=1) for p, q in zip(atu, v)])
            zinv = (live / jnp.maximum(z, _TINY))[:, None]
            for j in range(nt):
                vz_ref[rows, _tile(j)] = v[j] * zinv
                we_ref[rows, _tile(j)] = atu[j] * be[j] * zinv
            tk_ref[rows] = jnp.where(pad, -1, tok)
            nx = _times_at(v, a_ref, nt, prec)
            s = functools.reduce(jnp.add, [jnp.sum(x, axis=1) for x in nx])
            sinv = 1.0 / jnp.maximum(s, _TINY)
            return tuple(jnp.where(pad[:, None], b, x * sinv[:, None])
                         for b, x in zip(be, nx))

        be = jax.lax.fori_loop(0, chunk_t, rev, be)
        barrier()

        # the chunk's statistics, as products over its (t, window) rows
        _accumulate(da_ref,
                    lambda rows, i: u_ref[rows, pl.ds(i * _TILE, _TILE)],
                    vz_ref, nt, nt, n_rows, prec)

        def onehot(rows, i):
            cols = i * _TILE + jax.lax.broadcasted_iota(
                jnp.int32, (_ROWS, _TILE), 1)
            return (tk_ref[rows][:, None] == cols).astype(jnp.float32)

        _accumulate(db_ref, onehot, we_ref, _KP // _TILE, nt, n_rows, prec)
        barrier()
        return be

    be = jax.lax.fori_loop(
        0, n_chunks, chunk_body,
        tuple(jnp.ones((bw, _TILE), jnp.float32) for _ in range(nt)),
    )
    for j in range(nt):
        bef_ref[:, _tile(j)] = be[j]


def _prepare(a, bfull, pi, tokens, chunk_t: int,
             chunk_mult: int = 1):
    """Padded f32 operands shared by both kernels, and the t = 0 column.
    The time chunk is a multiple of ``chunk_mult`` columns."""
    f32 = jnp.float32
    m = a.shape[0]
    w, t_len = tokens.shape
    mp = padded_states(m)
    bw = BLOCK_W
    wp = _round_up(w, bw)
    a32 = jnp.zeros((mp, mp), f32).at[:m, :m].set(a.astype(f32))
    bt = jnp.zeros((_K, mp), f32).at[:, :m].set(bfull.T.astype(f32))

    tok0 = tokens[:, 0]
    pad0 = (tok0 == PAD_TOKEN)[:, None]
    e0 = jnp.where(pad0, 1.0, bt[jnp.maximum(tok0, 0), :m])
    al0 = pi[None, :].astype(f32) * e0
    s0 = jnp.sum(al0, axis=1)
    al0 = al0 / s0[:, None]
    al0_p = jnp.zeros((wp, mp), f32).at[:w, :m].set(al0)
    al0_p = al0_p.at[w:, 0].set(1.0)  # pad windows: a valid distribution
    acc0_p = jnp.zeros((wp,), ACC_DTYPE).at[:w].set(
        jnp.log(s0).astype(ACC_DTYPE))

    n_rest = t_len - 1
    tc = _round_up(max(1, min(chunk_t, n_rest)), chunk_mult)
    n_chunks = max(1, -(-n_rest // tc))
    tok_t = jnp.full((n_chunks * tc, wp), PAD_TOKEN, jnp.int32)
    tok_t = tok_t.at[:n_rest, :w].set(tokens[:, 1:].T.astype(jnp.int32))
    return dict(m=m, w=w, mp=mp, nt=mp // _TILE, bw=bw, wp=wp, tc=tc,
                n_chunks=n_chunks, a32=a32, bt=bt, e0=e0, s0=s0, al0=al0,
                al0_p=al0_p, acc0_p=acc0_p, tok_t=tok_t)


def _forward_call(p, with_chk: bool, interpret: bool):
    nt, bw, wp, mp = p["nt"], p["bw"], p["wp"], p["mp"]
    tc, n_chunks = p["tc"], p["n_chunks"]
    f32 = jnp.float32
    out_specs = [pl.BlockSpec((bw,), lambda i: (i,))]
    out_shape = [jax.ShapeDtypeStruct((wp,), ACC_DTYPE)]
    if with_chk:
        out_specs.append(pl.BlockSpec((n_chunks, bw, mp), lambda i: (0, i, 0)))
        out_shape.append(jax.ShapeDtypeStruct((n_chunks, wp, mp), f32))
    return pl.pallas_call(
        functools.partial(_fwd_kernel, nt=nt, chunk_t=tc, n_chunks=n_chunks,
                          prec=_precision(nt, interpret)),
        grid=(wp // bw,),
        in_specs=[
            pl.BlockSpec((n_chunks * tc, bw), lambda i: (0, i)),
            pl.BlockSpec((bw, mp), lambda i: (i, 0)),
            pl.BlockSpec((bw,), lambda i: (i,)),
            pl.BlockSpec((mp, mp), lambda i: (0, 0)),
            pl.BlockSpec((_K, mp), lambda i: (0, 0)),
        ],
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=_params(nt),
        interpret=interpret,
        name="itrails_forward",
    )(p["tok_t"], p["al0_p"], p["acc0_p"], p["a32"], p["bt"])


def total(ll):
    """Sum of per-window log-likelihoods in float64 when x64 is on: a
    genome-scale total is ~1e6 nats, where one f32 ULP is 0.125 — coarse
    enough to quantise away a short optimizer step's improvement."""
    return jnp.sum(ll.astype(ACC_DTYPE))


@functools.partial(jax.jit,
                   static_argnames=("chunk_t", "interpret"))
def forward_logliks(a, bfull, pi, tokens, *, chunk_t: int = 256,
                    interpret: bool = False):
    """Per-window log-likelihoods (W,) of a (W, T) token batch, right-padded
    with PAD_TOKEN (float64 when x64 is on, see ``ACC_DTYPE``)."""
    p = _prepare(a, bfull, pi, tokens, chunk_t)
    (ll,) = _forward_call(p, with_chk=False, interpret=interpret)
    return ll[:p["w"]]


def forward_loglik(a, bfull, pi, tokens, **kw):
    """Total log-likelihood of a (W, T) token batch via the kernel."""
    return total(forward_logliks(a, bfull, pi, tokens, **kw))


@functools.partial(jax.jit,
                   static_argnames=("chunk_t", "interpret"))
def loglik_and_grads(a, bfull, pi, tokens, *, chunk_t: int = 64,
                     interpret: bool = False):
    """``(total loglik, (da, dbfull, dpi))`` of a (W, T) token batch: the
    contract of ``jax.value_and_grad(hmm.grad.forward_loglik_remat,
    argnums=(0, 1, 2))``; pad windows and columns contribute nothing."""
    f32 = jnp.float32
    # the per-chunk statistics walk the chunk's (t, window) rows _ROWS at a
    # time, so a chunk holds a whole number of row groups
    p = _prepare(a, bfull, pi, tokens, chunk_t,
                 chunk_mult=max(1, _ROWS // BLOCK_W))
    m, w, mp, nt, bw, wp = (p[k] for k in ("m", "w", "mp", "nt", "bw", "wp"))
    tc, n_chunks = p["tc"], p["n_chunks"]
    ll, chk = _forward_call(p, with_chk=True, interpret=interpret)

    n_prog = wp // bw
    n_rows = tc * bw
    blk = lambda i: (i, 0, 0)  # noqa: E731
    da_p, db_p, bef, *_ = pl.pallas_call(
        functools.partial(_bwd_kernel, nt=nt, chunk_t=tc, n_chunks=n_chunks,
                          bw=bw, interpret=interpret),
        grid=(n_prog,),
        in_specs=[
            pl.BlockSpec((n_chunks * tc, bw), lambda i: (0, i)),
            pl.BlockSpec((n_chunks, bw, mp), lambda i: (0, i, 0)),
            pl.BlockSpec((mp, mp), lambda i: (0, 0)),
            pl.BlockSpec((_K, mp), lambda i: (0, 0)),
            pl.BlockSpec((None, mp, mp), blk),
            pl.BlockSpec((None, _KP, mp), blk),
        ],
        out_specs=[
            pl.BlockSpec((None, mp, mp), blk),
            pl.BlockSpec((None, _KP, mp), blk),
            pl.BlockSpec((bw, mp), lambda i: (i, 0)),
            pl.BlockSpec((None, n_rows, mp), blk),
            pl.BlockSpec((None, n_rows, mp), blk),
            pl.BlockSpec((None, n_rows, mp), blk),
            pl.BlockSpec((None, n_rows), lambda i: (i, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((n_prog, mp, mp), f32),
            jax.ShapeDtypeStruct((n_prog, _KP, mp), f32),
            jax.ShapeDtypeStruct((wp, mp), f32),
            jax.ShapeDtypeStruct((n_prog, n_rows, mp), f32),
            jax.ShapeDtypeStruct((n_prog, n_rows, mp), f32),
            jax.ShapeDtypeStruct((n_prog, n_rows, mp), f32),
            jax.ShapeDtypeStruct((n_prog, n_rows), jnp.int32),
        ],
        input_output_aliases={4: 0, 5: 1},
        backend="triton",
        compiler_params=_params(nt),
        interpret=interpret,
        name="itrails_backward",
    )(p["tok_t"], chk, p["a32"], p["bt"],
      jnp.zeros((n_prog, mp, mp), f32), jnp.zeros((n_prog, _KP, mp), f32))

    # t = 0 column (pi and its emission) on the XLA side:
    #   dpi_j          = e0_j beta0_j / (Z0 s0)
    #   dbfull[j, v0] += pi_j beta0_j / (Z0 s0)
    al0, e0, s0 = p["al0"], p["e0"], p["s0"]
    tok0 = tokens[:, 0]
    live0 = (tok0 != PAD_TOKEN).astype(f32)
    bef_w = bef[:w, :m]
    z0 = jnp.sum(al0 * bef_w, axis=1)
    # dpi is deliberately NOT masked for all-pad windows, matching
    # grad.forward_loglik_remat: an empty window contributes log(sum(pi)),
    # identically 0 in value but with gradient 1/sum(pi) per element (a null
    # direction of the model, since sum(pi) == 1 for every parameter)
    coef = 1.0 / jnp.maximum(z0 * s0, _TINY)
    dpi = jnp.sum(e0 * bef_w * coef[:, None], axis=0)
    q0 = pi[None, :].astype(f32) * bef_w * (coef * live0)[:, None]
    oh0 = (tok0[:, None] == jnp.arange(_K, dtype=tok0.dtype)[None, :])
    db0 = jnp.dot(oh0.astype(f32).T, q0, precision=jax.lax.Precision.HIGHEST)

    da = jnp.sum(da_p, axis=0)[:m, :m]
    db = (jnp.sum(db_p, axis=0)[:_K, :m] + db0).T
    dt = a.dtype
    return total(ll[:w]), (da.astype(dt), db.astype(dt), dpi.astype(dt))
