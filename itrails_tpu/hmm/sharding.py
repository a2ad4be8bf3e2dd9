"""Device-mesh data parallelism for the HMM decoders.

Alignment windows are the data-parallel axis: a 1-D ``jax.sharding.Mesh``
over all local (or distributed) devices shards the window dimension, every
per-step (W, M) @ (M, M) matmul runs device-local, and the only collective
is the ``psum`` XLA inserts for the final log-likelihood sum (or the gather
of posterior/Viterbi outputs).  This subsumes the reference's joblib
process-pool over blocks (optimizer.py:56-62) and is the multi-host story:
with ``jax.distributed`` initialized, the same code spans hosts.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from itrails_tpu.hmm import decoders

__all__ = ["data_mesh", "shard_batch", "sharded_forward_loglik",
           "sharded_loglik_fn", "sharded_posterior", "sharded_viterbi"]


def data_mesh(devices=None) -> Mesh:
    """1-D mesh over the given (default: all) devices, axis name 'data'."""
    devices = jax.devices() if devices is None else devices
    return Mesh(np.array(devices), axis_names=("data",))


def shard_batch(tokens, mesh: Mesh):
    """Place a (W, T) token batch window-sharded on the mesh.  W must be a
    multiple of the mesh size (pad with all-PAD windows — they are neutral)."""
    sharding = NamedSharding(mesh, P("data", None))
    return jax.device_put(tokens, sharding)


@functools.partial(jax.jit, static_argnames=())
def _loglik(a, bfull, pi, tokens):
    return decoders.forward_loglik(a, bfull, pi, tokens)


def sharded_loglik_fn(mesh: Mesh):
    """Jitted (a, bfull, pi, tokens) -> total loglik, explicitly shard_mapped
    over the 'data' axis.  Each device decodes its local window shard
    through decoders.forward_loglik_fast (the Pallas-Triton kernel on a
    CUDA device) and the scalar sums merge with one psum."""

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P("data", None)), out_specs=P(),
        # pallas_call out_shapes carry no vma metadata; the body is a plain
        # per-shard map + psum, so the varying-mesh-axes check adds nothing
        check_vma=False,
    )
    def f(a, bfull, pi, tokens):
        return jax.lax.psum(
            decoders.forward_loglik_fast(a, bfull, pi, tokens), "data"
        )

    return f


def sharded_forward_loglik(a, bfull, pi, tokens, mesh: Mesh):
    """Total log-likelihood of a window batch, data-parallel over the mesh.
    The reduction over windows becomes an XLA psum across devices."""
    tokens = shard_batch(tokens, mesh)
    return _loglik(a, bfull, pi, tokens)


def sharded_posterior(a, bfull, pi, tokens, mesh: Mesh):
    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P("data", None)),
        out_specs=P(None, "data", None), check_vma=False,
    )
    def f(a, bfull, pi, tokens):
        return decoders.posterior(a, bfull, pi, tokens)

    return f(a, bfull, pi, shard_batch(tokens, mesh))


def sharded_viterbi(a, bfull, pi, tokens, mesh: Mesh):
    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P("data", None)),
        out_specs=P("data", None), check_vma=False,
    )
    def f(a, bfull, pi, tokens):
        return decoders.viterbi(a, bfull, pi, tokens)

    return f(a, bfull, pi, shard_batch(tokens, mesh))
