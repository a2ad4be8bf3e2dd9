"""Benchmark: alignment columns/second/chip for the decoders of the
3-species coalescent HMM (the per-optimizer-eval hot loop), across all
four production model families:

  * plain 3x3   (M=27,  the default topology)       -> headline value
  * plain 7x7   (M=133, BASELINE config 3)          -> m133_* fields
  * introgression 3x3 (M=36)                        -> int36_* fields
  * introgression 7x7 (M=182)                       -> int182_* fields

plus realistic-data variants (tokens simulated from the model with N
bursts, ~98% unambiguous — real-MAF statistics) and cold/warm-cache
model-build latencies.  Needs a GPU: it exits with an error when JAX finds
none.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

Baseline: single-core iTRAILS runs the same recursion as a numba-compiled
loop (reference optimizer.py:165-188); tools/measure_baseline.py times a
C -O3 build of it (BASELINE_MEASURED.json) for the measured baseline.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Fallback only: a generous single-core numba estimate (M=27) when
# BASELINE_MEASURED.json is absent.
BASELINE_COLS_PER_SEC = 2.5e6

PLAIN = dict(t_A=0.0024, t_B=0.0024, t_C=0.0028, t_2=0.0004,
             t_upper=0.00745069, t_out=0.009312, N_AB=0.0005, N_ABC=0.0005,
             r=1.0)
INT = dict(t_A=0.0024, t_B=0.0016, t_C=0.0016, t_2=0.0004,
           t_upper=0.00745069, t_out=0.009312, t_m=0.0008, N_AB=0.0005,
           N_BC=0.0004, N_ABC=0.0005, r=1.0, m=0.1)

# (windows, columns) per decoder and family
SHAPES = {
    "": {"fwd": (4096, 8192), "viterbi": (2048, 8192),
         "posterior": (4096, 8192)},
    "m133_": {"fwd": (2048, 8192), "viterbi": (1024, 8192),
              "posterior": (2048, 4096)},
    "int36_": {"fwd": (2048, 8192), "viterbi": (1024, 8192),
               "posterior": (2048, 4096)},
    "int182_": {"fwd": (1024, 8192), "viterbi": (512, 8192),
                "posterior": (1024, 4096)},
}


def measured_baseline():
    path = os.path.join(REPO, "BASELINE_MEASURED.json")
    if os.path.exists(path):
        with open(path) as f:
            d = json.load(f)
        return float(d["c_cols_per_s"]), {
            "baseline_measured_cols_per_s": d["c_cols_per_s"],
            "baseline_provenance": (
                "single-core C -O3 of the reference forward recursion, "
                "measured by tools/measure_baseline.py (reference "
                "pure-Python itself: "
                f"{d['python_cols_per_s']:.0f} cols/s)"
            ),
        }
    return BASELINE_COLS_PER_SEC, {
        "baseline_provenance": "estimate (run tools/measure_baseline.py)"
    }


def _subprocess_build_s(kind, params, n_ab, n_abc):
    """Cold-process model build wall clock (seconds), measured inside a
    child interpreter that stays on the CPU (the build's device) — what a
    NEW process pays after this one populated the on-disk caches."""
    fn = ("build_model_introgression" if kind == "int" else "build_model")
    mod = ("itrails_tpu.introgression.builder" if kind == "int"
           else "itrails_tpu.core.model")
    code = f"""
import sys, time
sys.path.insert(0, {REPO!r})
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from itrails_tpu.utils.cache import enable_compilation_cache
enable_compilation_cache()
from {mod} import {fn}
t0 = time.time()
m = {fn}(n_int_AB={n_ab}, n_int_ABC={n_abc}, dtype="float64", device="cpu",
         **{params!r})
m.a.block_until_ready()
print("BUILD_S", time.time() - t0)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=REPO, check=True)
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("BUILD_S ")]
    return round(float(line[-1].split()[1]), 3)


def main():
    import jax

    jax.config.update("jax_enable_x64", True)  # f64 model build on host
    from itrails_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()  # persist compiles across runs
    import jax.numpy as jnp
    import numpy as np

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    from itrails_tpu.core.model import build_model
    from itrails_tpu.data.simulate import simulate_token_batch
    from itrails_tpu.data.tokens import aggregation_matrix
    from itrails_tpu.hmm import decoders
    from itrails_tpu.introgression.builder import build_model_introgression

    cast = jnp.float32
    agg = jnp.asarray(aggregation_matrix(), cast)
    rng = np.random.default_rng(0)
    extras = {}

    def tables(model):
        a = jax.device_put(jnp.asarray(model.a, cast), dev)
        pi = jax.device_put(jnp.asarray(model.pi, cast), dev)
        bfull = jax.device_put(
            decoders.emission_table(jnp.asarray(model.b, cast), agg), dev
        )
        return a, bfull, pi

    def time_rates(g, a, bfull, pi, tokens, reps=4):
        """(median Mcol/s, [min, max]) over ``reps`` timed calls."""
        g(a, bfull, pi, tokens).block_until_ready()  # compile + warm up
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            g(a, bfull, pi, tokens).block_until_ready()
            ts.append(time.perf_counter() - t0)
        rates = sorted(tokens.size / t / 1e6 for t in ts)
        return (round(float(np.median(rates)), 1),
                [round(rates[0], 1), round(rates[-1], 1)])

    decoders_ = {
        "fwd": jax.jit(decoders.forward_loglik_fast),
        "viterbi": jax.jit(lambda a_, b_, p_, t_: decoders.viterbi(
            a_, b_, p_, t_)[:, -1].sum()),
        "posterior": jax.jit(lambda a_, b_, p_, t_: decoders.posterior(
            a_, b_, p_, t_)[-1].sum()),
    }

    def decode_suite(prefix, model, seed):
        """fwd/viterbi/posterior rates on uniform tokens, then re-timed on
        tokens simulated from the model (same compiled programs)."""
        a, bfull, pi = tables(model)
        w_max = max(w for w, _ in SHAPES[prefix].values())
        t_max = max(t for _, t in SHAPES[prefix].values())
        uniform = jax.device_put(jnp.asarray(
            rng.integers(0, 625, size=(w_max, t_max)), jnp.int32), dev)
        sim = jax.device_put(jnp.asarray(
            simulate_token_batch(model, w_max, t_max, seed=seed)), dev)
        for name, g in decoders_.items():
            w, t_len = SHAPES[prefix][name]
            key = f"{prefix}{name}_mcols_per_s"
            extras[key], extras[f"{prefix}{name}_mcols_range"] = time_rates(
                g, a, bfull, pi, uniform[:w, :t_len])
            extras[f"{key}_realistic"], _ = time_rates(
                g, a, bfull, pi, sim[:w, :t_len])
        return a, bfull, pi

    def eval_loop(prefix, build_fn, fwd, a, bfull, pi):
        """Full optimizer-evaluation wall clock: model rebuild + forward
        likelihood on a 1 Mb batch (BASELINE config 2 shape)."""
        mb = jax.device_put(
            jnp.asarray(rng.integers(0, 625, size=(256, 4096)), jnp.int32),
            dev)
        fwd(a, bfull, pi, mb).block_until_ready()  # compile the 1 Mb shape

        def one_eval(da):
            a2, b2, p2 = tables(build_fn(da))
            fwd(a2, b2, p2, mb).block_until_ready()

        one_eval(1.7e-6)  # warm
        ts = []
        for k in range(5):
            t0 = time.perf_counter()
            one_eval(1e-7 * (k + 1))
            ts.append(time.perf_counter() - t0)
        extras[f"{prefix}optimizer_eval_s"] = round(float(np.median(ts)), 3)

    def build_times(prefix, build, params, n_ab, n_abc):
        t0 = time.perf_counter()
        model = build(**params, n_int_AB=n_ab, n_int_ABC=n_abc,
                      dtype="float64", device="cpu")
        model.a.block_until_ready()
        extras[f"{prefix}build_s_first"] = round(time.perf_counter() - t0, 3)
        bts = []
        for k in range(4):  # steady-state per-eval rebuild (param changed)
            t0 = time.perf_counter()
            model = build(**{**params, "t_A": params["t_A"] + 1e-6 * (k + 1)},
                          n_int_AB=n_ab, n_int_ABC=n_abc, dtype="float64",
                          device="cpu")
            model.a.block_until_ready()
            bts.append(time.perf_counter() - t0)
        extras[f"{prefix}build_s_cached"] = round(float(np.median(bts[1:])),
                                                  3)
        return model

    # ---- plain 3x3 (M=27): headline -------------------------------------
    from itrails_tpu.utils import cache as ucache

    akey = ucache.model_artifact_key(
        "plain", 3, 3, "float64", list(PLAIN.values()))
    extras["model_build_s_first_artifact_hit"] = bool(
        ucache.model_artifact_get(akey) is not None)
    t0 = time.perf_counter()
    model = build_model(**PLAIN, n_int_AB=3, n_int_ABC=3, dtype="float64",
                        device="cpu")
    model.a.block_until_ready()
    build_first_s = time.perf_counter() - t0
    # cold-process rebuilds now that this process populated the caches:
    # same params -> model-artifact cache; new params -> persistent XLA
    # compile cache
    extras["model_build_s_first_warm_cache"] = _subprocess_build_s(
        "plain", PLAIN, 3, 3)
    extras["model_build_s_new_params_warm_cache"] = _subprocess_build_s(
        "plain", {**PLAIN, "t_A": 0.002407}, 3, 3)
    # every later build varies a parameter, so the artifact layer could
    # only add per-build npz writes: keep the timings free of disk IO
    os.environ["ITRAILS_NO_CACHE"] = "1"
    model = build_times("m27_", build_model, PLAIN, 3, 3)
    extras["model_build_s_cached"] = extras.pop("m27_build_s_cached")
    del extras["m27_build_s_first"]
    a, bfull, pi_ = decode_suite("", model, seed=11)
    eval_loop("", lambda da: build_model(
        **{**PLAIN, "t_A": PLAIN["t_A"] + da, "N_AB": 0.000501},
        n_int_AB=3, n_int_ABC=3, dtype="float64", device="cpu"),
        decoders_["fwd"], a, bfull, pi_)
    extras["optimizer_eval_s_1mb"] = extras.pop("optimizer_eval_s")
    fwd_w, fwd_t = SHAPES[""]["fwd"]
    tokens = jax.device_put(jnp.asarray(
        rng.integers(0, 625, size=(fwd_w, fwd_t)), jnp.int32), dev)
    ll = float(decoders_["fwd"](a, bfull, pi_, tokens))
    cols_per_sec = extras["fwd_mcols_per_s"] * 1e6
    del a, bfull, pi_, tokens

    # ---- plain 7x7 (M=133), introgression 3x3 (M=36) and 7x7 (M=182) ----
    for prefix, build, params, (n_ab, n_abc), seed in (
        ("m133_", build_model, PLAIN, (7, 7), 12),
        ("int36_", build_model_introgression, INT, (3, 3), 13),
        ("int182_", build_model_introgression, INT, (7, 7), 14),
    ):
        m = build_times(prefix, build, params, n_ab, n_abc)
        tabs = decode_suite(prefix, m, seed)
        eval_loop(prefix, lambda da, build=build, params=params, n_ab=n_ab,
                  n_abc=n_abc: build(
                      **{**params, "t_A": params["t_A"] + da},
                      n_int_AB=n_ab, n_int_ABC=n_abc, dtype="float64",
                      device="cpu"),
                  decoders_["fwd"], *tabs)
        del tabs

    base_rate, base_info = measured_baseline()
    extras.update(base_info)
    print(json.dumps({
        "metric": "alignment columns/sec/chip (3-species HMM forward, M=27)",
        "value": round(cols_per_sec, 1),
        "unit": "columns/s/chip",
        "vs_baseline": round(cols_per_sec / base_rate, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "batch": list(SHAPES[""]["fwd"]),
        "loglik": ll,
        "model_build_s_first": round(build_first_s, 3),
        **extras,
    }))


if __name__ == "__main__":
    main()
