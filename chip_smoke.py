#!/usr/bin/env python3
"""End-to-end smoke test of itrails-tpu on NVIDIA GPUs.

Run from the root of a checkout:

    python3 chip_smoke.py                # one card: kernel, timing, pipeline
    python3 chip_smoke.py --four-cards   # only the mesh-sharded paths, 4 cards

Phases (each asserts; the first failure ends the run with a non-zero exit
code, and nothing is caught and continued):

* kernel: the four model widths the repo supports (plain 3x3 / 7x7,
  M = 27 / 133; introgression 3x3 / 7x7, M = 36 / 182), built with
  bench.py's parameters, at bench.py's batch sizes, on tokens simulated from
  each model with N bursts.  The Pallas-Triton forward and gradient kernels
  run as compiled for the card and are compared with the float64 XLA
  references; the compiled production dispatch is checked to hold the
  Triton kernel exactly where it serves float32 requests, and never for
  float64 requests.
* timing: each kernel against the XLA program it replaces, and the XLA
  Viterbi and posterior decoders, as JSON lines.
* pipeline: a simulated four-species MAF of ~1.05 Mb (heavy-tailed block
  lengths, N bursts, one block above LONG_BLOCK_THRESHOLD) through the
  CLIs of both families, run in this process through their main():
  optimize (exact-gradient L-BFGS-B and Nelder-Mead, float32), then viterbi
  and posterior from the written best model.  A 50 kb slice is decoded
  again in float64 by a child process that never opens the card.

``--four-cards`` runs only the window-sharded and sequence-parallel paths
on a 1-D mesh of 4 cards and compares each with the same call on one card.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import csv
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances.  Kernels compute in float32 and are held to float64
# references: the total log-likelihood to 1e-5 relative, each gradient to
# 1e-4 of its largest entry.  A float64 request runs the float64 scan.
LL_RTOL_F32 = 1e-5
LL_RTOL_F64 = 1e-10
GRAD_RTOL_F32 = 1e-4
# Where the dispatch runs XLA's f32 autodiff of the scan instead of the
# gradient kernel (M = 133/182), its gradients are held to 1e-3: on tokens
# simulated from these slowly mixing chains the f32 rounding of the beta
# recursion accumulates along T (measured 5.5e-4 at M = 133).
XLA_GRAD_RTOL_F32 = 1e-3
# the same call on a 4-card and a 1-card mesh
MESH_RTOL = {"float64": 1e-9, "float32": 1e-5}
POST_ATOL = 1e-6

T_KERNEL = 8192
WIDTHS = (  # family, intervals per axis, states, windows (bench.py's sizes)
    ("plain", 3, 27, 4096),
    ("plain", 7, 133, 2048),
    ("int", 3, 36, 2048),
    ("int", 7, 182, 2048),
)
SPECIES = ["hg38", "panTro5", "gorGor5", "ponAbe2"]
GENOME_SHORT_COLUMNS = 750_000  # heavy-tailed short blocks
GENOME_LONG_BLOCK = 300_000  # one block above LONG_BLOCK_THRESHOLD
FOUR_CARD_SHORT_COLUMNS = 60_000
SLICE_COLUMNS = 50_000  # re-decoded on the CPU in float64
OPT_ITERS = 3


def log(**kw):
    print(json.dumps(kw), flush=True)


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def kernel_in(compiled_text):
    """True when a compiled program holds a Pallas-Triton kernel."""
    return "__gpu$xla.gpu.triton" in compiled_text


def start(n_cards):
    if not os.path.isdir(os.path.join(ROOT, "itrails_tpu")):
        fail("itrails_tpu/ is not beside this script: run it from a checkout")
    sys.path.insert(0, ROOT)
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"needs NVIDIA GPUs; JAX found platform {devs[0].platform!r}")
    if len(devs) < n_cards:
        fail(f"needs {n_cards} cards; JAX found {len(devs)}")
    jax.config.update("jax_enable_x64", True)
    from itrails_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    for line in smi[:n_cards]:
        print(line)
    print(f"device_kind={devs[0].device_kind} jax={jax.__version__} "
          f"devices={len(devs)}", flush=True)
    return jax


# --- shared helpers -------------------------------------------------------------


def build(family, n):
    """A model with bench.py's parameters."""
    from bench import INT, PLAIN
    from itrails_tpu.core.model import build_model
    from itrails_tpu.introgression.builder import build_model_introgression

    if family == "plain":
        return build_model(**PLAIN, n_int_AB=n, n_int_ABC=n,
                           dtype="float64", device="cpu")
    return build_model_introgression(**INT, n_int_AB=n, n_int_ABC=n,
                                     dtype="float64", device="cpu")


def tables(jax, model, dtype, device=None):
    """(a, bfull, pi) in ``dtype`` on ``device`` (None: uncommitted, free
    to follow a mesh)."""
    import jax.numpy as jnp
    import numpy as np

    from itrails_tpu.data.tokens import aggregation_matrix
    from itrails_tpu.hmm import decoders

    def put(x):
        x = jnp.asarray(np.asarray(x), dtype)
        return x if device is None else jax.device_put(x, device)

    a, b, pi = put(model.a), put(model.b), put(model.pi)
    return a, decoders.emission_table(b, put(aggregation_matrix())), pi


def timeit(jax, f, *args, n=2):
    """Least wall time of ``n`` calls, after one warm-up call."""
    jax.block_until_ready(f(*args))
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def grad_errors(got, ref):
    import numpy as np

    out = {}
    for name, x, y in zip(("da", "dbfull", "dpi"), got, ref):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        check(np.all(np.isfinite(x)), f"non-finite {name}")
        out[name] = float(np.max(np.abs(x - y)) / np.max(np.abs(y)))
    return out


# --- kernel and timing phases ---------------------------------------------------


def kernel_phase(jax):
    import jax.numpy as jnp

    from itrails_tpu.data.simulate import simulate_token_batch
    from itrails_tpu.hmm import decoders, grad, triton_hmm

    gpu = jax.devices()[0]
    f64, f32 = jnp.float64, jnp.float32
    fast = jax.jit(decoders.forward_loglik_fast)
    fast_vg = jax.jit(grad.loglik_and_grads)
    kern = jax.jit(triton_hmm.forward_loglik)
    kern_vg = jax.jit(triton_hmm.loglik_and_grads)
    scan = jax.jit(lambda *x: triton_hmm.total(decoders.forward(*x)[1]))
    autodiff = jax.jit(jax.value_and_grad(grad.forward_loglik_remat,
                                          argnums=(0, 1, 2)))
    timings = []
    for family, n, m, w in WIDTHS:
        t0 = time.perf_counter()
        model = build(family, n)
        check(model.a.shape == (m, m), f"{family} {n}x{n}: M != {m}")
        build_s = time.perf_counter() - t0
        tok = jax.device_put(
            simulate_token_batch(model, w, T_KERNEL, seed=m), gpu)
        t32 = tables(jax, model, f32, gpu)
        t64 = tables(jax, model, f64, gpu)
        ref = float(scan(*t64, tok))
        check(ref < 0 and ref == ref, f"M={m}: bad reference {ref}")

        # the production dispatch, as compiled for the card: the forward
        # kernel serves every float32 width, the gradient kernel the widths
        # of triton_hmm.serves_gradient; float64 always runs the scan
        grad_served = triton_hmm.serves_gradient(m)
        for label, fn, args, want in (
                ("forward f32", fast, t32, True),
                ("gradient f32", fast_vg, t32, grad_served),
                ("forward f64", fast, t64, False),
                ("gradient f64", fast_vg, t64, False)):
            has = kernel_in(fn.lower(*args, tok).compile().as_text())
            check(has == want, f"M={m} {label}: Triton kernel in the "
                  f"compiled dispatch is {has}, expected {want}")
        ll32 = float(fast(*t32, tok))
        ll64 = float(fast(*t64, tok))
        check(abs(ll32 / ref - 1) < LL_RTOL_F32,
              f"M={m}: f32 dispatch {ll32} vs f64 reference {ref}")
        check(abs(ll64 / ref - 1) < LL_RTOL_F64,
              f"M={m}: f64 dispatch {ll64} vs f64 reference {ref}")

        # the kernels themselves, at this width (the gradient where the
        # dispatch serves it; elsewhere the dispatch's autodiff)
        t0 = time.perf_counter()
        llk = float(kern(*t32, tok))
        fwd_compile_s = time.perf_counter() - t0
        vg32 = kern_vg if grad_served else fast_vg
        t0 = time.perf_counter()
        llg, gk = jax.block_until_ready(vg32(*t32, tok))
        grad_compile_s = time.perf_counter() - t0
        llr, gr = autodiff(*t64, tok)
        errs = grad_errors(gk, gr)
        rel_k = abs(llk / ref - 1)
        rel_g = abs(float(llg) / float(llr) - 1)
        log(phase="kernel", m=m, windows=w, columns=T_KERNEL,
            gradient_kernel=grad_served, build_s=build_s,
            fwd_compile_s=fwd_compile_s, grad_compile_s=grad_compile_s,
            loglik_f64=ref, rel_dispatch_f32=abs(ll32 / ref - 1),
            rel_dispatch_f64=abs(ll64 / ref - 1), rel_kernel_fwd=rel_k,
            rel_grad_ll=rel_g, **{f"rel_{k}": v for k, v in errs.items()})
        check(rel_k < LL_RTOL_F32 and rel_g < LL_RTOL_F32,
              f"M={m}: f32 loglik off ({rel_k}, {rel_g})")
        check(max(errs.values()) < (GRAD_RTOL_F32 if grad_served
                                    else XLA_GRAD_RTOL_F32),
              f"M={m}: f32 gradient off {errs}")

        timings.append(dict(
            phase="timing", m=m, windows=w, columns=T_KERNEL,
            programs=-(-w // triton_hmm.BLOCK_W),
            fwd_kernel_s=timeit(jax, kern, *t32, tok),
            fwd_xla_f32_s=timeit(jax, scan, *t32, tok),
            fwd_xla_f64_s=timeit(jax, scan, *t64, tok),
            grad_xla_f32_s=timeit(jax, autodiff, *t32, tok),
            grad_xla_f64_s=timeit(jax, autodiff, *t64, tok),
        ))
        if grad_served:
            timings[-1]["grad_kernel_s"] = timeit(jax, kern_vg, *t32, tok)
        if family == "plain":
            wd = 512
            vit = jax.jit(lambda *x: decoders.viterbi(*x)[:, -1].sum())
            post = jax.jit(lambda *x: decoders.posterior(*x)[-1].sum())
            timings[-1].update(
                decode_windows=wd,
                viterbi_xla_f32_s=timeit(jax, vit, *t32, tok[:wd]),
                viterbi_xla_f64_s=timeit(jax, vit, *t64, tok[:wd]),
                posterior_xla_f32_s=timeit(jax, post, *t32, tok[:wd]),
                posterior_xla_f64_s=timeit(jax, post, *t64, tok[:wd]),
            )
        del tok, t32, t64
    for t in timings:
        log(**t)


# --- pipeline phase ---------------------------------------------------------------


def simulate_genome(model, path, short_columns, long_block, seed=0):
    """Four-species MAF: heavy-tailed short blocks (log-normal lengths,
    median 5 kb, 300 b to 60 kb) and one long block, all with N bursts.
    Returns the block lengths in file order."""
    import numpy as np

    from itrails_tpu.data.simulate import simulate_token_batch, write_maf

    rng = np.random.default_rng(seed)
    lengths = []
    while sum(lengths) < short_columns:
        lengths.append(int(np.clip(rng.lognormal(np.log(5000), 1.2),
                                   300, 60_000)))
    batch = simulate_token_batch(model, len(lengths), max(lengths), seed=seed)
    blocks = [batch[i, :n] for i, n in enumerate(lengths)]
    blocks.insert(len(blocks) // 2,
                  simulate_token_batch(model, 1, long_block, seed=seed + 1)[0])
    write_maf(path, blocks, SPECIES)
    return [len(b) for b in blocks]


def optimize_config(family, maf, n_int):
    from itrails_tpu.config import load_yaml

    name = "example_config_int.yaml" if family == "int" else \
        "example_config.yaml"
    cfg = load_yaml(os.path.join(ROOT, "examples", name))
    cfg["settings"].update(input_maf=maf, output_prefix=None,
                           n_int_AB=n_int, n_int_ABC=n_int)
    cfg["settings"].pop("n_cpu", None)
    return cfg


def read_history(path):
    import numpy as np

    with open(path) as f:
        rows = list(csv.reader(f))
    check(rows[0][0] == "n_eval" and len(rows) >= 3,
          f"{path}: expected a header and >= 2 evaluations")
    body = np.asarray(rows[1:], np.float64)
    check(np.all(np.isfinite(body[:, -2])), f"{path}: non-finite loglik")
    return rows[0], body


def per_eval_s(history):
    """Median wall time of one evaluation, the first (compiling) one
    excluded: the history's time column is cumulative."""
    import numpy as np

    return float(np.median(np.diff(history[:, -1])[1:]))


def run_optimize(family, cfg_path, out, extra):
    from itrails_tpu.cli import int_optimize, optimize

    main = int_optimize.main if family == "int" else optimize.main
    t0 = time.perf_counter()
    main([cfg_path, "--output", out, "--maxiter", str(OPT_ITERS),
          "--precision", "float32", *extra])
    return time.perf_counter() - t0


def expand_viterbi(path, lengths, m):
    """Per-block state paths from the run-length-encoded Viterbi CSV; every
    column must be covered exactly once."""
    import numpy as np

    paths = [np.full(n, -1, np.int64) for n in lengths]
    with open(path) as f:
        rows = list(csv.reader(f))[1:]
    for blk, s, e, state in (map(int, r) for r in rows):
        check(np.all(paths[blk][s:e + 1] == -1), f"{path}: overlap")
        paths[blk][s:e + 1] = state
    for p in paths:
        check(np.all((p >= 0) & (p < m)), f"{path}: a column has no state")
    return paths


def read_posterior(path, lengths, m):
    import numpy as np

    with open(path) as f:
        header = f.readline().strip().split(",")
        check(len(header) == m + 2, f"{path}: {len(header)} columns")
        flat = np.array(f.read().replace("\n", ",").rstrip(",").split(","),
                        np.float64)
    rows = flat.reshape(-1, m + 2)
    check(len(rows) == sum(lengths), f"{path}: {len(rows)} rows for "
          f"{sum(lengths)} columns")
    sums = rows[:, 2:].sum(axis=1)
    check(np.all(np.abs(sums - 1.0) <= POST_ATOL),
          f"{path}: row sums off by {np.max(np.abs(sums - 1.0))}")
    out, off = [], 0
    for n in lengths:
        out.append(rows[off:off + n, 2:])
        off += n
    return out


_CPU_DECODE = r"""
import sys
sys.path.insert(0, {root!r})
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
from itrails_tpu.cli import decode
from itrails_tpu.cli.common import prepare_decode_setup
from itrails_tpu.config import load_yaml
from itrails_tpu.data.maf import maf_tokens
setup = prepare_decode_setup(load_yaml({best!r}), introgression={intro})
setup["introgression"] = {intro}
_, a, bfull, pi = decode.build(setup, "float64")
v_lst = maf_tokens({maf!r}, {species!r})
sel = {blocks!r}
vit = decode.run_viterbi(a, bfull, pi, [v_lst[i] for i in sel])
post = decode.run_posterior(a, bfull, pi, [v_lst[i] for i in sel])
assert jax.devices()[0].platform == "cpu"
np.savez({out!r}, **{{f"v{{i}}": np.asarray(v) for i, v in zip(sel, vit)}},
         **{{f"p{{i}}": np.asarray(p) for i, p in zip(sel, post)}})
"""


def cpu_decode(best, maf, blocks, intro, out):
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    code = _CPU_DECODE.format(root=ROOT, best=best, intro=intro, maf=maf,
                              species=SPECIES, blocks=blocks, out=out)
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=900)


def pipeline_phase(jax, work):
    import numpy as np

    from itrails_tpu.cli.common import prepare_decode_setup
    from itrails_tpu.config import dump_yaml, load_yaml
    from itrails_tpu.data.maf import maf_tokens
    from itrails_tpu.optim.optimizer import LoglikEngine

    maf = os.path.join(work, "genome.maf")
    t0 = time.perf_counter()
    lengths = simulate_genome(build("plain", 3), maf, GENOME_SHORT_COLUMNS,
                              GENOME_LONG_BLOCK)
    log(phase="genome", blocks=len(lengths), columns=sum(lengths),
        longest=max(lengths), seconds=time.perf_counter() - t0)
    v_lst = maf_tokens(maf, SPECIES)
    check([len(v) for v in v_lst] == lengths, "MAF round trip changed blocks")
    sel, n = [], 0
    for i, ln in enumerate(lengths):
        if ln <= 60_000 and n < SLICE_COLUMNS:
            sel.append(i)
            n += ln

    per_eval = {}
    for family, n_int, m in (("plain", 3, 27), ("int", 3, 36)):
        intro = family == "int"
        sep = "_" if intro else "."
        cfg_path = os.path.join(work, f"{family}.yaml")
        with open(cfg_path, "w") as f:
            dump_yaml(optimize_config(family, maf, n_int), f)
        for tag, extra in (("grad", []), ("nm", ["--no-grad"])):
            out = os.path.join(work, family, tag, "run")
            wall = run_optimize(family, cfg_path, out, extra)
            _, hist = read_history(f"{out}{sep}optimization_history.csv")
            best = load_yaml(f"{out}{sep}best_model.yaml")
            ll = best["results"]["log_likelihood"]
            check(np.isfinite(ll), f"{family}/{tag}: best loglik {ll}")
            per_eval[f"{family}_{tag}"] = per_eval_s(hist)
            log(phase="optimize", family=family, run=tag, evals=len(hist),
                wall_s=wall, per_eval_s=per_eval[f"{family}_{tag}"],
                best_loglik=ll)

        # the best model, re-evaluated with the float64 XLA scan
        best_path = os.path.join(work, family, "grad",
                                 f"run{sep}best_model.yaml")
        best = load_yaml(best_path)
        setup = prepare_decode_setup(best, introgression=intro)
        engine = LoglikEngine(v_lst, n_int, n_int, dtype="float64",
                              introgression=intro)
        ll64 = engine.loglik(setup["params"])
        ll32 = best["results"]["log_likelihood"]
        log(phase="reeval", family=family, loglik_f32_kernel=ll32,
            loglik_f64_scan=ll64, rel=abs(ll32 / ll64 - 1))
        check(abs(ll32 / ll64 - 1) < LL_RTOL_F32,
              f"{family}: best loglik {ll32} vs f64 re-evaluation {ll64}")

        # viterbi and posterior from the written best model (float64)
        chain = os.path.join(work, family, "chain")
        vmod, pmod = (("int_viterbi", "int_posterior") if intro
                      else ("viterbi", "posterior"))
        timings = {}
        for mod in (vmod, pmod):
            module = __import__(f"itrails_tpu.cli.{mod}", fromlist=["main"])
            t0 = time.perf_counter()
            module.main([best_path, "--output", chain])
            timings[mod] = time.perf_counter() - t0
        vit = expand_viterbi(f"{chain}.viterbi.csv", lengths, m)
        post = read_posterior(f"{chain}.posterior.csv", lengths, m)

        # a 50 kb slice, decoded again on the CPU in float64
        ref = os.path.join(work, family, "cpu_slice.npz")
        t0 = time.perf_counter()
        cpu_decode(best_path, maf, sel, intro, ref)
        with np.load(ref) as z:
            vit_same = all(np.array_equal(z[f"v{i}"], vit[i]) for i in sel)
            post_err = max(float(np.max(np.abs(z[f"p{i}"] - post[i])))
                           for i in sel)
        log(phase="decode", family=family, viterbi_s=timings[vmod],
            posterior_s=timings[pmod], slice_blocks=len(sel),
            slice_columns=int(sum(lengths[i] for i in sel)),
            cpu_slice_s=time.perf_counter() - t0,
            viterbi_identical=vit_same, posterior_max_abs_diff=post_err)
        check(vit_same, f"{family}: Viterbi differs from the CPU decode")
        check(post_err <= POST_ATOL,
              f"{family}: posterior off the CPU decode by {post_err}")
    log(phase="per_eval", **per_eval)


# --- four cards ----------------------------------------------------------------


def four_cards_phase(jax, work):
    import jax.numpy as jnp
    import numpy as np

    from itrails_tpu.cli import optimize
    from itrails_tpu.cli.common import prepare_optimize_setup
    from itrails_tpu.config import dump_yaml
    from itrails_tpu.data.maf import maf_tokens
    from itrails_tpu.data.simulate import simulate_token_batch
    from itrails_tpu.hmm import longseq_sharded, sharding
    from itrails_tpu.optim.cases import resolve_times
    from itrails_tpu.optim.optimizer import LoglikEngine

    devs = jax.devices()[:4]
    mesh4, mesh1 = sharding.data_mesh(devs), sharding.data_mesh(devs[:1])
    model = build("plain", 3)
    maf = os.path.join(work, "genome.maf")
    lengths = simulate_genome(model, maf, FOUR_CARD_SHORT_COLUMNS,
                              GENOME_LONG_BLOCK)
    v_lst = maf_tokens(maf, SPECIES)
    cfg = optimize_config("plain", maf, 3)
    setup = prepare_optimize_setup(cfg)
    params = resolve_times(setup["case"], {
        **setup["fixed_dict"],
        **dict(zip(setup["optim_variables"], setup["optim_list"]))})

    def rel(x, y):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        return float(np.max(np.abs(x - y)) / max(np.max(np.abs(y)), 1e-300))

    for dtype in ("float64", "float32"):
        tol = MESH_RTOL[dtype]
        engines = [LoglikEngine(v_lst, 3, 3, dtype=dtype, mesh=mesh)
                   for mesh in (mesh4, mesh1)]
        check(engines[0].long_blocks and engines[0].buckets,
              "expected both window buckets and a long block")
        lls = [e.loglik(params) for e in engines]
        vgs = [e.loglik_and_grad_fn(setup["optim_variables"],
                                    setup["fixed_dict"], setup["case"],
                                    resolve_times) for e in engines]
        x = np.asarray(setup["optim_list"], np.float64)
        (l4, g4), (l1, g1) = (f(x) for f in vgs)
        log(phase="four_cards_engine", dtype=dtype, loglik_4=lls[0],
            loglik_1=lls[1], rel_value=rel(lls[0], lls[1]),
            rel_value_grad=rel(l4, l1), rel_grad=rel(g4, g1))
        check(rel(lls[0], lls[1]) < tol and rel(l4, l1) < tol
              and rel(g4, g1) < tol, f"{dtype}: 4-card engine differs")

    a, bfull, pi = tables(jax, model, jnp.float64)
    tok = jnp.asarray(simulate_token_batch(model, 256, 4096, seed=5))
    v4 = np.asarray(sharding.sharded_viterbi(a, bfull, pi, tok, mesh4))
    v1 = np.asarray(sharding.sharded_viterbi(a, bfull, pi, tok, mesh1))
    p4 = np.asarray(sharding.sharded_posterior(a, bfull, pi, tok, mesh4))
    p1 = np.asarray(sharding.sharded_posterior(a, bfull, pi, tok, mesh1))
    long_tok = jnp.asarray(v_lst[int(np.argmax(lengths))], jnp.int32)
    ll4 = float(longseq_sharded.sharded_forward_loglik_long(
        a, bfull, pi, long_tok, mesh4))
    ll1 = float(longseq_sharded.sharded_forward_loglik_long(
        a, bfull, pi, long_tok, mesh1))
    q4 = np.asarray(longseq_sharded.sharded_posterior_long(
        a, bfull, pi, long_tok, mesh4))
    q1 = np.asarray(longseq_sharded.sharded_posterior_long(
        a, bfull, pi, long_tok, mesh1))
    log(phase="four_cards_decode", viterbi_identical=bool(np.array_equal(
        v4, v1)), posterior_max_abs_diff=float(np.max(np.abs(p4 - p1))),
        long_loglik_rel=rel(ll4, ll1),
        long_posterior_max_abs_diff=float(np.max(np.abs(q4 - q1))))
    check(np.array_equal(v4, v1), "sharded Viterbi differs")
    check(np.max(np.abs(p4 - p1)) <= POST_ATOL, "sharded posterior differs")
    check(rel(ll4, ll1) < MESH_RTOL["float64"], "long-block loglik differs")
    check(np.max(np.abs(q4 - q1)) <= POST_ATOL, "long posterior differs")

    # a few optimize iterations on the 4-card mesh; every evaluation it
    # records is recomputed on one card
    cfg_path = os.path.join(work, "plain.yaml")
    with open(cfg_path, "w") as f:
        dump_yaml(cfg, f)
    out = os.path.join(work, "opt4", "run")
    optimize.main([cfg_path, "--output", out, "--maxiter", "2"])
    header, hist = read_history(f"{out}.optimization_history.csv")
    names = header[1:-2]
    check(names == setup["optim_variables"], f"history columns {names}")
    one = LoglikEngine(v_lst, 3, 3, dtype="float64", mesh=mesh1)
    worst = 0.0
    for row in hist:
        d = resolve_times(setup["case"], {**setup["fixed_dict"],
                                          **dict(zip(names, row[1:-2]))})
        worst = max(worst, rel(row[-2], one.loglik(d)))
    log(phase="four_cards_optimize", evals=len(hist), worst_rel=worst)
    check(worst < MESH_RTOL["float64"], "4-card optimize evals differ")


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the mesh-sharded paths on 4 cards")
    args = p.parse_args()
    n_cards = 4 if args.four_cards else 1
    jax = start(n_cards)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if args.four_cards:
            four_cards_phase(jax, work)
        else:
            kernel_phase(jax)
            pipeline_phase(jax, work)
    dev = jax.devices()[0]
    log(phase="done", seconds=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": n_cards}}))


if __name__ == "__main__":
    main()
