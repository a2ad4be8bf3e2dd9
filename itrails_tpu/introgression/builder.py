"""Full introgression HMM model builder: parameters -> (a, b, pi)
(the reference's trans_emiss_calc_introgression, int_get_trans_emiss.py:9-185)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from itrails_tpu.core.cutpoints import cutpoints_ab, cutpoints_abc
from itrails_tpu.core.emissions import emission_matrix_introgression
from itrails_tpu.core.model import HmmModel
from itrails_tpu.core.schedule import build_plan
from itrails_tpu.introgression.model import int_joint_matrix

__all__ = ["build_model_introgression", "build_model_introgression_fn"]


def _build(plan, t_A, t_B, t_C, t_2, t_upper, t_out, t_m, N_AB, N_BC, N_ABC,
           r, m, cut_AB=None, cut_ABC=None, dtype=jnp.float64):
    """Parameters arrive mu-scaled as in the reference workflows; ``t_B`` and
    ``t_C`` run from the present to the migration event
    (int_get_trans_emiss.py:72-101)."""
    n_ref = N_ABC
    t_a = t_A / n_ref
    t_b = t_B / n_ref
    t_ab = t_2 / n_ref
    t_c = t_C / n_ref
    t_mm = t_m / n_ref
    t_up = t_upper / n_ref
    t_o = t_out / n_ref
    rho = n_ref * r
    coal_ab = n_ref / N_AB
    coal_bc = n_ref / N_BC
    mu_scale = n_ref * (4.0 / 3.0)

    if cut_AB is None:
        cut_AB = cutpoints_ab(plan.n_int_AB, t_ab, coal_ab, dtype)
    if cut_ABC is None:
        cut_ABC = cutpoints_abc(plan.n_int_ABC, 1.0, dtype)

    joint = int_joint_matrix(
        plan,
        t_A=t_a, t_B=t_b, t_C=t_c, t_AB=t_ab, t_m=t_mm,
        coal_A=coal_ab, coal_B=coal_ab, coal_C=coal_bc,
        coal_AB=coal_ab, coal_BC=coal_bc, coal_ABC=1.0,
        rho=rho, m=m,
        cut_AB=cut_AB, cut_ABC=cut_ABC, dtype=dtype,
    )
    pi = jnp.sum(joint, axis=1)
    a = joint / pi[:, None]

    b = emission_matrix_introgression(
        n_int_AB=plan.n_int_AB, n_int_ABC=plan.n_int_ABC,
        t_A=t_a, t_B=t_b, t_C=t_c, t_AB=t_ab, t_m=t_mm,
        t_upper=t_up, t_out=t_o,
        coal_AB=coal_ab, coal_BC=coal_bc, coal_ABC=1.0,
        mu=mu_scale, cut_AB=cut_AB, cut_ABC=cut_ABC, dtype=dtype,
    )
    return a, b, pi, cut_AB, cut_ABC


@functools.lru_cache(maxsize=8)
def build_model_introgression_fn(n_int_AB: int, n_int_ABC: int,
                                 dtype_name: str = "float64",
                                 device: str | None = "cpu"):
    plan = build_plan(n_int_AB, n_int_ABC, introgression=True)
    dtype = jnp.dtype(dtype_name)

    def fn(t_A, t_B, t_C, t_2, t_upper, t_out, t_m, N_AB, N_BC, N_ABC, r, m,
           cut_AB=None, cut_ABC=None):
        return _build(plan, t_A, t_B, t_C, t_2, t_upper, t_out, t_m, N_AB,
                      N_BC, N_ABC, r, m, cut_AB=cut_AB, cut_ABC=cut_ABC,
                      dtype=dtype)

    if device is not None:
        dev = jax.devices(device)[0]
        jit_fn = jax.jit(fn)  # one jit instance: trace once, reuse forever

        def wrapped(*args, **kwargs):
            with jax.default_device(dev):
                return jit_fn(*args, **kwargs)

        return wrapped
    return jax.jit(fn)


def build_model_introgression(
    t_A, t_B, t_C, t_2, t_upper, t_out, t_m, N_AB, N_BC, N_ABC, r, m,
    n_int_AB: int, n_int_ABC: int, dtype=jnp.float64, device="cpu",
    cut_AB=None, cut_ABC=None,
) -> HmmModel:
    """Convenience wrapper (reference int_get_trans_emiss.py:9-185).
    Exact-parameter rebuilds are served from the on-disk model-artifact
    cache — see core.model.build_model."""
    from itrails_tpu.utils import cache as _cache

    args = [t_A, t_B, t_C, t_2, t_upper, t_out, t_m, N_AB, N_BC, N_ABC, r, m]
    akey = _cache.model_artifact_key(
        "int", n_int_AB, n_int_ABC, jnp.dtype(dtype).name, args,
        cut_AB, cut_ABC,
    )
    hit = _cache.model_artifact_get(akey)
    if hit is not None:
        plan = build_plan(n_int_AB, n_int_ABC, introgression=True)
        # placement mirrors core.model.build_model's artifact-hit path
        # (on `device` but uncommitted)
        with jax.default_device(jax.devices(device)[0]
                                if device is not None else None):
            out = {k: jnp.asarray(v) for k, v in hit.items()}
        return HmmModel(a=out["a"], b=out["b"], pi=out["pi"],
                        hidden_states=plan.hidden_states,
                        cut_AB=out["cut_AB"], cut_ABC=out["cut_ABC"])
    fn = build_model_introgression_fn(n_int_AB, n_int_ABC,
                                      jnp.dtype(dtype).name, device)
    kwargs = {}
    if cut_AB is not None:
        kwargs["cut_AB"] = jnp.asarray(cut_AB, dtype)
    if cut_ABC is not None:
        cut_ABC = jnp.asarray(cut_ABC, dtype)
        if cut_ABC.shape[0] == n_int_ABC:
            cut_ABC = jnp.concatenate([cut_ABC, jnp.zeros(1, dtype)])
        else:
            cut_ABC = cut_ABC.at[-1].set(0.0)
        kwargs["cut_ABC"] = cut_ABC
    a, b, pi, cut_ab, cut_abc = fn(t_A, t_B, t_C, t_2, t_upper, t_out, t_m,
                                   N_AB, N_BC, N_ABC, r, m, **kwargs)
    _cache.model_artifact_put(akey, a, b, pi, cut_ab, cut_abc)
    plan = build_plan(n_int_AB, n_int_ABC, introgression=True)
    return HmmModel(a=a, b=b, pi=pi, hidden_states=plan.hidden_states,
                    cut_AB=cut_ab, cut_ABC=cut_abc)
