"""Outer maximum-likelihood optimizer.

The reference's hot loop (optimizer.py:396-637): scipy Nelder-Mead /
L-BFGS-B over the free parameters; each objective evaluation rebuilds
(a, b, pi) and sums the forward log-likelihood over all alignment blocks.
Here the model rebuild is one jitted call (CPU, f64) and the likelihood is
one jitted data-parallel scan over the padded window batch on the
accelerator mesh — no process pools, no per-eval recompilation.

Artifacts per evaluation match the reference: a row
``[n_eval, params..., loglik, seconds]`` appended to
``<prefix>.optimization_history.csv`` and a conditional best-model YAML
update.
"""

from __future__ import annotations

import functools
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
from scipy.optimize import minimize

from itrails_tpu.config import dump_yaml, update_best_model
from itrails_tpu.core.model import build_model_fn
from itrails_tpu.data.tokens import aggregation_matrix
from itrails_tpu.hmm import decoders, sharding, windows
from itrails_tpu.optim.cases import resolve_times, resolve_times_introgression

__all__ = ["LoglikEngine", "optimizer", "write_list"]


def write_list(lst, path):
    """Append one comma-separated row (reference optimizer.py:380-393)."""
    with open(path, "a") as f:
        f.write(",".join(str(x) for x in lst) + "\n")


def _acc4(acc, new):
    """Accumulate (ll, da, db, dpi) tuples (None-initialised)."""
    if acc[0] is None:
        return new
    return tuple(x + y for x, y in zip(acc, new))


class LoglikEngine:
    """Packs alignment blocks once and evaluates the total forward
    log-likelihood for a parameter dictionary.

    Whole-genome layouts: short blocks are grouped into power-of-two
    length-class buckets (windows.plan_buckets) so one chromosome-scale
    block never forces T_max padding on kilobase blocks, and blocks above
    ``long_threshold`` columns are evaluated exactly through the
    sequence-parallel transfer-operator path (hmm/longseq*.py) — mesh-
    sharded when more than one device is present.  Every block keeps its
    exact recurrence (no splitting), so the total equals the single-batch
    log-likelihood up to float summation order.  The reference's only
    parallel axis is one joblib process per block (reference
    optimizer.py:56-62)."""

    def __init__(self, v_lst, n_int_AB, n_int_ABC, dtype="float64",
                 mesh=None, long_threshold=windows.LONG_BLOCK_THRESHOLD,
                 chunk=1024, introgression=False):
        from itrails_tpu.hmm import longseq, longseq_sharded

        self.mesh = sharding.data_mesh() if mesh is None else mesh
        n_dev = self.mesh.devices.size
        lengths = [len(v) for v in v_lst]
        self._n_columns = int(sum(lengths))
        bucket_idx, long_idx = windows.plan_buckets(
            lengths, n_dev, long_threshold
        )
        self.buckets = []
        for idxs in bucket_idx:
            tokens, _, _ = windows.pack_windows(
                [v_lst[i] for i in idxs], pad_windows_to=n_dev,
                pad_length_to=128,
            )
            self.buckets.append(
                sharding.shard_batch(jnp.asarray(tokens), self.mesh)
            )
        self.long_blocks = [
            jnp.asarray(np.asarray(v_lst[i], np.int32)) for i in long_idx
        ]
        self.n_int_AB = n_int_AB
        self.n_int_ABC = n_int_ABC
        self.dtype = dtype
        self.introgression = introgression
        # the per-eval model build runs in f64 on the host CPU, whatever the
        # decode precision; the tables are cast to ``dtype`` for the decode
        from itrails_tpu.utils.cache import enable_compilation_cache

        enable_compilation_cache()
        if introgression:
            from itrails_tpu.introgression.builder import (
                build_model_introgression_fn,
            )

            self._builder = build_model_introgression_fn(
                n_int_AB, n_int_ABC, "float64", device="cpu"
            )
        else:
            self._builder = build_model_fn(n_int_AB, n_int_ABC, "float64",
                                           device="cpu")
        self._agg = jnp.asarray(aggregation_matrix())
        self._loglik = sharding.sharded_loglik_fn(self.mesh)
        self._chunk = chunk
        if n_dev > 1:
            self._long_fn = functools.partial(
                longseq_sharded.sharded_forward_loglik_long,
                mesh=self.mesh, chunk=chunk,
            )
        else:
            self._long_fn = jax.jit(
                functools.partial(longseq.forward_loglik_long, chunk=chunk)
            )
        self._long_vg = jax.jit(jax.value_and_grad(
            functools.partial(longseq.forward_loglik_long_remat, chunk=chunk),
            argnums=(0, 1, 2),
        ))

    @property
    def n_columns(self) -> int:
        return self._n_columns

    def _decode(self, a, bfull, pi):
        """Total log-likelihood over all buckets and long blocks (jax
        scalar)."""
        parts = [self._loglik(a, bfull, pi, tok) for tok in self.buckets]
        parts += [self._long_fn(a, bfull, pi, tok) for tok in self.long_blocks]
        if not parts:
            return jnp.zeros((), bfull.dtype)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    def loglik_and_grad_fn(self, optim_variables, fixed_params, case,
                           resolver):
        """Callable ``vec -> (loglik, dloglik/dvec)`` with exact gradients:
        value+grad of the decode w.r.t. (a, bfull, pi) on the accelerator
        mesh, chained through a CPU-f64 ``jax.vjp`` of the model build and
        the (differentiable) case algebra.  The reference has no gradient
        path at all — its L-BFGS-B uses finite differences."""
        from itrails_tpu.hmm import grad as hmm_grad

        if self.introgression:
            from itrails_tpu.introgression.builder import (
                build_model_introgression_fn,
            )

            pure_build = build_model_introgression_fn(
                self.n_int_AB, self.n_int_ABC, "float64", device=None
            )
            arg_names = ["t_A", "t_B", "t_C", "t_2", "t_upper", "t_out",
                         "t_m", "N_AB", "N_BC", "N_ABC", "r", "m"]
        else:
            pure_build = build_model_fn(
                self.n_int_AB, self.n_int_ABC, "float64", device=None
            )
            arg_names = ["t_A", "t_B", "t_C", "t_2", "t_upper", "t_out",
                         "N_AB", "N_ABC", "r"]

        cpu = jax.devices("cpu")[0]
        cast = jnp.dtype(self.dtype)
        agg = self._agg
        decode_vg = hmm_grad.decode_value_and_grad_fn(self.mesh)

        def build_from_vec(vec):
            d = dict(fixed_params)
            for name, v in zip(optim_variables, vec):
                d[name] = v
            d = resolver(case, d)
            a, b, pi, _, _ = pure_build(*[d[n] for n in arg_names])
            return a, b, pi

        def f(vec_np):
            # commit to the host device: the f64 build and its VJP below
            # stay on the host CPU with the rest of the model build
            vec = jax.device_put(
                jnp.asarray(np.asarray(vec_np, np.float64)), cpu
            )
            with jax.default_device(cpu):
                (a, b, pi), build_vjp = jax.vjp(build_from_vec, vec)
            # detach the build outputs from the host device commitment so
            # the decode inputs can follow the mesh placement
            a_h, b_h, pi_h = (jnp.asarray(np.asarray(x))
                              for x in (a, b, pi))
            bfull = decoders.emission_table(
                b_h.astype(cast), agg.astype(cast)
            )
            ac, bc, pc = (a_h.astype(cast), bfull.astype(cast),
                          pi_h.astype(cast))
            ll = da = dbfull = dpi = None
            for tok in self.buckets:
                l_, (da_, db_, dp_) = decode_vg(ac, bc, pc, tok)
                ll, da, dbfull, dpi = _acc4(
                    (ll, da, dbfull, dpi), (l_, da_, db_, dp_)
                )
            for tok in self.long_blocks:
                l_, (da_, db_, dp_) = self._long_vg(ac, bc, pc, tok)
                ll, da, dbfull, dpi = _acc4(
                    (ll, da, dbfull, dpi), (l_, da_, db_, dp_)
                )
            db = jnp.asarray(dbfull, jnp.float64) @ jnp.asarray(
                agg, jnp.float64
            )
            with jax.default_device(cpu):
                # cotangents arrive committed to the accelerator; move
                # them to the host, where the build's VJP runs
                (gvec,) = build_vjp(tuple(
                    jax.device_put(jnp.asarray(g, jnp.float64), cpu)
                    for g in (da, db, dpi)
                ))
            return float(ll), np.asarray(gvec, np.float64)

        return f

    def loglik(self, params: dict) -> float:
        if self.introgression:
            args = (
                params["t_A"], params["t_B"], params["t_C"], params["t_2"],
                params["t_upper"], params["t_out"], params["t_m"],
                params["N_AB"], params["N_BC"], params["N_ABC"],
                params["r"], params["m"],
            )
        else:
            args = (
                params["t_A"], params["t_B"], params["t_C"], params["t_2"],
                params["t_upper"], params["t_out"], params["N_AB"],
                params["N_ABC"], params["r"],
            )
        a, b, pi, _, _ = self._builder(*args)
        cast = jnp.dtype(self.dtype)
        bfull = decoders.emission_table(b.astype(cast), self._agg.astype(cast))
        return float(self._decode(a.astype(cast), bfull, pi.astype(cast)))


def optimizer(
    optim_variables,
    optim_list,
    bounds,
    fixed_params,
    v_lst,
    res_name,
    case,
    method="Nelder-Mead",
    header=True,
    maxiter=10000,
    dtype="float64",
    engine=None,
    introgression=False,
    use_grad=False,
):
    """Run the outer optimization (reference optimizer.py:586-637,
    int_optimizer.py:589-651).

    Returns the scipy result object.  ``res_name`` is the output
    path/prefix; ``<res_name>.optimization_history.csv`` and
    ``<res_name>.best_model.yaml`` follow the reference contract (the int
    family uses '_'-separated artifact names like the reference).
    """
    output_dir, output_prefix = os.path.split(res_name)
    sep = "_" if introgression else "."
    history = os.path.join(
        output_dir, f"{output_prefix}{sep}optimization_history.csv"
    )
    best_model_yaml = os.path.join(output_dir, f"{output_prefix}{sep}best_model.yaml")
    if header:
        write_list(["n_eval"] + list(optim_variables) + ["loglik", "time"], history)

    if introgression:
        # first-eval state-map artifacts (reference int_optimizer.py:551-560;
        # written to the output directory rather than the CWD, and up front
        # since the index maps are parameter-independent)
        import csv

        from itrails_tpu.core.schedule import hidden_state_list
        from itrails_tpu.data.tokens import token_strings

        hidden = hidden_state_list(
            fixed_params["n_int_AB"], fixed_params["n_int_ABC"],
            introgression=True,
        )
        with open(os.path.join(output_dir, "hidden_states.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(["idx", "hidden"])
            w.writerows([i, str(h)] for i, h in enumerate(hidden))
        with open(os.path.join(output_dir, "observed_states.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(["idx", "observed"])
            w.writerows(enumerate(token_strings()[:256]))

    if engine is None:
        engine = LoglikEngine(
            v_lst, fixed_params["n_int_AB"], fixed_params["n_int_ABC"],
            dtype=dtype, introgression=introgression,
        )
    info = {"n_eval": 0, "t0": time.time()}
    resolver = resolve_times_introgression if introgression else resolve_times

    # Mid-run search-state checkpoint (SURVEY.md section 5 ask): the scipy
    # iteration callback atomically records the CURRENT iterate (internal
    # mu-scaled coordinates), so --resume can restart the trajectory from
    # where it stopped rather than only from the best-so-far YAML.
    state_yaml = os.path.join(
        output_dir, f"{output_prefix}{sep}optimizer_state.yaml"
    )

    def _checkpoint(xk):
        tmp = state_yaml + ".tmp"
        with open(tmp, "w") as f:
            dump_yaml({
                "n_eval": info["n_eval"],
                "variables": list(optim_variables),
                "x_internal": [float(v) for v in np.asarray(xk)],
                "note": "internal (mu-scaled) coordinates; consumed by "
                        "--resume",
            }, f)
        os.replace(tmp, state_yaml)

    def _record(arg_lst, ll):
        write_list(
            [info["n_eval"]] + [float(v) for v in arg_lst]
            + [ll, time.time() - info["t0"]],
            history,
        )
        if os.path.exists(best_model_yaml):
            update_best_model(best_model_yaml, optim_variables, arg_lst, ll,
                              info["n_eval"])
        info["n_eval"] += 1

    # At extreme bound corners (e.g. t_upper/N_ABC ~ 1e3 coalescent units)
    # the model build overflows to non-finite values; a large finite
    # penalty keeps line searches and simplex steps backtracking instead
    # of propagating NaN into scipy's termination logic.
    _PENALTY = 1e12

    if use_grad:
        vg = engine.loglik_and_grad_fn(
            optim_variables, fixed_params, case, resolver
        )

        # Optimize in a per-variable scaled space z = x / s, s = |x0|:
        # scipy's L-BFGS-B line search takes O(1)-norm first steps, which
        # in raw coalescent units (t ~ 1e-3, m ~ 0.25, spanning 3 orders)
        # either explodes past the bounds into the non-finite penalty
        # region or stalls the Wolfe bracket entirely — the measured
        # introgression "stall at x0" of an earlier unscaled run.  The exact
        # gradient itself is correct (FD parity 4e-12,
        # tests/test_grad.py::test_int_gradient_fd_parity); only the
        # search geometry was broken.  z-space has z0 = 1 for every
        # variable.  History/best-model/checkpoint all record x, never z.
        scale = np.maximum(np.abs(np.asarray(optim_list, np.float64)),
                           1e-30)

        # Non-finite builds (e.g. introgression t_1 < t_m gives negative
        # branch lengths) need a SOFT, sloped penalty here: a flat 1e12
        # cliff with zero gradient makes scipy's quadratic line-search
        # interpolation collapse the next trial step below the decode's
        # f32 value noise, aborting the whole run at its start point (the
        # measured round-3/round-4 introgression stall).  A quadratic bowl
        # anchored at the start point always slopes back toward
        # feasibility.  The bowl's base is scaled to the data: genome-
        # scale objectives (-loglik) easily exceed a fixed 1e7, which
        # would otherwise make the infeasible region score BETTER than
        # every feasible point, so the base tracks 10x the largest finite
        # objective magnitude seen so far (1e7 floor before the first
        # finite eval).
        _PENALTY_SOFT = 1e7
        obj_scale = {"max_abs": 0.0}

        # the z-space anchor below assumes every start value is positive
        # (z0 = 1); a nonpositive x0 would flip the penalty slope or
        # degenerate the scaling, so fail loudly instead of silently
        assert np.all(np.asarray(optim_list, np.float64) > 0.0), (
            "grad path requires strictly positive starting values "
            f"(got {list(optim_list)})"
        )

        def objective(z):
            z = np.asarray(z, np.float64)
            arg_lst = z * scale
            ll, g = vg(arg_lst)
            _record(arg_lst, ll)
            if not (np.isfinite(ll) and np.all(np.isfinite(g))):
                base = max(10.0 * obj_scale["max_abs"], _PENALTY_SOFT)
                dz = z - 1.0  # start point is all-ones in z-space
                return (base * (1.0 + float(dz @ dz)), 2.0 * base * dz)
            obj_scale["max_abs"] = max(obj_scale["max_abs"], abs(float(ll)))
            return -ll, -np.asarray(g, np.float64) * scale

        res = minimize(
            objective,
            x0=np.asarray(optim_list, dtype=np.float64) / scale,
            method=method,
            jac=True,
            bounds=[(lo / s, hi / s) for (lo, hi), s in zip(bounds, scale)],
            callback=lambda zk: _checkpoint(np.asarray(zk) * scale),
            options={"maxiter": maxiter, "disp": True},
        )
        res.x = np.asarray(res.x) * scale  # report in natural coordinates
        return res

    def objective(arg_lst):
        d = dict(fixed_params)
        for name, value in zip(optim_variables, arg_lst):
            d[name] = float(value)
        d = resolver(case, d)
        ll = engine.loglik(d)
        _record(arg_lst, ll)
        return _PENALTY if not np.isfinite(ll) else -ll

    return minimize(
        objective,
        x0=np.asarray(optim_list, dtype=np.float64),
        method=method,
        bounds=bounds,
        callback=_checkpoint,
        options={"maxiter": maxiter, "disp": True},
    )
