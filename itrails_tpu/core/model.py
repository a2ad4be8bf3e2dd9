"""Full HMM model builder: parameters -> (a, b, pi).

The jittable equivalent of the reference's per-evaluation model rebuild
(get_trans_emiss.py:8-170): normalizes demographic parameters into
coalescent units, builds the joint transition table via the compiled
interval-DP plan, the emission matrix via batched JC69 tensor contractions,
and returns the HMM parameter triple.  The whole function is jittable; the
plan (all combinatorics) is baked in as constants per (n_int_AB, n_int_ABC).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from itrails_tpu.core.ctmc import joint_matrix
from itrails_tpu.core.cutpoints import cutpoints_ab, cutpoints_abc
from itrails_tpu.core.emissions import emission_matrix
from itrails_tpu.core.schedule import build_plan

__all__ = ["HmmModel", "build_model", "build_model_fn"]


@dataclass
class HmmModel:
    a: jnp.ndarray  # (M, M) row-stochastic transition matrix
    b: jnp.ndarray  # (M, 256) emission probabilities over unambiguous 4-mers
    pi: jnp.ndarray  # (M,) stationary/initial distribution
    hidden_states: list  # sorted (topology, i, j) tuples
    cut_AB: jnp.ndarray
    cut_ABC: jnp.ndarray


def _build(plan, t_A, t_B, t_C, t_2, t_upper, t_out, N_AB, N_ABC, r,
           cut_AB=None, cut_ABC=None, dtype=jnp.float64):
    """Core jittable computation.  Parameters arrive mu-scaled exactly as in
    the reference workflows (times and Ne multiplied by the mutation rate,
    r divided by it; workflow_optimize.py:387-398)."""
    n_ref = N_ABC
    t_a = t_A / n_ref
    t_b = t_B / n_ref
    t_ab = t_2 / n_ref
    t_c = t_C / n_ref
    t_up = t_upper / n_ref
    t_o = t_out / n_ref
    rho = n_ref * r
    coal_ab = n_ref / N_AB
    coal_abc = 1.0
    mu_scale = n_ref * (4.0 / 3.0)

    if cut_AB is None:
        cut_AB = cutpoints_ab(plan.n_int_AB, t_ab, coal_ab, dtype)
    if cut_ABC is None:
        cut_ABC = cutpoints_abc(plan.n_int_ABC, coal_abc, dtype)

    joint = joint_matrix(
        plan,
        coal_A=coal_ab,
        coal_B=coal_ab,
        coal_C=coal_ab,
        coal_AB=coal_ab,
        coal_ABC=coal_abc,
        rho_A=rho,
        rho_B=rho,
        rho_C=rho,
        rho_AB=rho,
        rho_ABC=rho,
        t_A=t_a,
        t_B=t_b,
        t_C=t_c,
        cut_AB=cut_AB,
        cut_ABC=cut_ABC,
        dtype=dtype,
    )
    pi = jnp.sum(joint, axis=1)
    a = joint / pi[:, None]

    b = emission_matrix(
        n_int_AB=plan.n_int_AB,
        n_int_ABC=plan.n_int_ABC,
        t_A=t_a,
        t_B=t_b,
        t_C=t_c,
        t_AB=t_ab,
        t_upper=t_up,
        t_out=t_o,
        coal_AB=coal_ab,
        coal_ABC=coal_abc,
        mu_A=mu_scale,
        mu_B=mu_scale,
        mu_C=mu_scale,
        mu_D=mu_scale,
        mu_AB=mu_scale,
        mu_ABC=mu_scale,
        cut_AB=cut_AB,
        cut_ABC=cut_ABC,
        dtype=dtype,
    )
    return a, b, pi, cut_AB, cut_ABC


@functools.lru_cache(maxsize=8)
def build_model_fn(n_int_AB: int, n_int_ABC: int, dtype_name: str = "float64",
                   device: str | None = "cpu", manual_cuts: bool = False):
    """A jit-compiled ``params -> (a, b, pi, cut_AB, cut_ABC)`` builder.

    By default the build runs in f64 on the host CPU (it is tiny — a few
    ms — while the genome-scale decoding runs on the accelerator).  With
    ``manual_cuts`` the function takes two extra trailing arguments: the
    cutpoint arrays in coalescent units (last ABC entry ignored)."""
    plan = build_plan(n_int_AB, n_int_ABC)
    dtype = jnp.dtype(dtype_name)

    def fn(t_A, t_B, t_C, t_2, t_upper, t_out, N_AB, N_ABC, r,
           cut_AB=None, cut_ABC=None):
        return _build(plan, t_A, t_B, t_C, t_2, t_upper, t_out, N_AB, N_ABC,
                      r, cut_AB=cut_AB, cut_ABC=cut_ABC, dtype=dtype)

    if device is not None:
        dev = jax.devices(device)[0]
        jit_fn = jax.jit(fn)  # one jit instance: trace once, reuse forever

        def wrapped(*args, **kwargs):
            with jax.default_device(dev):
                return jit_fn(*args, **kwargs)

        return wrapped
    return jax.jit(fn)


def build_model(
    t_A, t_B, t_C, t_2, t_upper, t_out, N_AB, N_ABC, r,
    n_int_AB: int, n_int_ABC: int, dtype=jnp.float64, device="cpu",
    cut_AB=None, cut_ABC=None,
) -> HmmModel:
    """Convenience wrapper returning an :class:`HmmModel` (the reference's
    trans_emiss_calc signature, get_trans_emiss.py:8-60).  ``cut_AB`` /
    ``cut_ABC`` optionally override the standard quantile cutpoints
    (coalescent units; ABC may include a trailing inf, which is replaced).

    Rebuilds of an exact parameter point are served from the on-disk
    model-artifact cache (utils/cache.py): the optimize -> viterbi ->
    posterior pipeline rebuilds the same best-fit model in each CLI
    process, and the hit turns that into a ~10 ms npz load (bit-identical
    arrays).  Opt out with ITRAILS_NO_CACHE=1."""
    from itrails_tpu.utils import cache as _cache

    args = [t_A, t_B, t_C, t_2, t_upper, t_out, N_AB, N_ABC, r]
    akey = _cache.model_artifact_key(
        "plain", n_int_AB, n_int_ABC, jnp.dtype(dtype).name, args,
        cut_AB, cut_ABC,
    )
    hit = _cache.model_artifact_get(akey)
    if hit is not None:
        plan = build_plan(n_int_AB, n_int_ABC)
        # place like the build path would: created under default_device
        # the arrays live on `device` but stay UNCOMMITTED, so downstream
        # accelerator ops can pull them freely (an explicit device_put
        # would commit them and break mixed-device decode calls)
        with jax.default_device(jax.devices(device)[0]
                                if device is not None else None):
            out = {k: jnp.asarray(v) for k, v in hit.items()}
        return HmmModel(a=out["a"], b=out["b"], pi=out["pi"],
                        hidden_states=plan.hidden_states,
                        cut_AB=out["cut_AB"], cut_ABC=out["cut_ABC"])
    fn = build_model_fn(n_int_AB, n_int_ABC, jnp.dtype(dtype).name, device)
    kwargs = {}
    if cut_AB is not None:
        kwargs["cut_AB"] = jnp.asarray(cut_AB, dtype)
    if cut_ABC is not None:
        cut_ABC = jnp.asarray(cut_ABC, dtype)
        if cut_ABC.shape[0] == n_int_ABC:  # final infinite bound implicit
            cut_ABC = jnp.concatenate([cut_ABC, jnp.zeros(1, dtype)])
        else:
            cut_ABC = cut_ABC.at[-1].set(0.0)
        kwargs["cut_ABC"] = cut_ABC
    a, b, pi, cut_ab, cut_abc = fn(*args, **kwargs)
    _cache.model_artifact_put(akey, a, b, pi, cut_ab, cut_abc)
    plan = build_plan(n_int_AB, n_int_ABC)
    return HmmModel(a=a, b=b, pi=pi, hidden_states=plan.hidden_states,
                    cut_AB=cut_ab, cut_ABC=cut_abc)
