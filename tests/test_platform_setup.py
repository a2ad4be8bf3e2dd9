"""What the GPU port pins down off the card: full-precision products in every
XLA decode program, where the compile cache lives, the MAF writer's full
alphabet, and chip_smoke.py refusing to run without a GPU."""

import os
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from itrails_tpu.hmm import decoders, grad, longseq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(m=9, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.random((m, m)) + np.eye(m)
    a /= a.sum(1, keepdims=True)
    bfull = rng.random((m, 625)) * 0.01 + 1e-4
    pi = np.full(m, 1.0 / m)
    return tuple(jnp.asarray(x, jnp.float32) for x in (a, bfull, pi))


def _batch(w=4, t=64):
    rng = np.random.default_rng(1)
    return jnp.asarray(rng.integers(0, 625, size=(w, t)), jnp.int32)


def _vg_remat(a, bfull, pi, tok):
    return jax.value_and_grad(
        lambda *x: grad.forward_loglik_remat(*x, tok, chunk=16),
        argnums=(0, 1, 2))(a, bfull, pi)


def _vg_long(a, bfull, pi, tok):
    return jax.value_and_grad(
        lambda *x: longseq.forward_loglik_long_remat(*x, tok[0], chunk=64),
        argnums=(0, 1, 2))(a, bfull, pi)


PROGRAMS = {
    "forward": lambda a, b, p, t: decoders.forward_loglik(a, b, p, t),
    "posterior": lambda a, b, p, t: decoders.posterior(a, b, p, t),
    "gradient": _vg_remat,
    "long_forward": lambda a, b, p, t: longseq.forward_loglik_long(
        a, b, p, t[0], chunk=16),
    "long_posterior": lambda a, b, p, t: longseq.posterior_long(
        a, b, p, t[0], chunk=16),
    "long_gradient": _vg_long,
    "emission_table": lambda a, b, p, t: decoders.emission_table(
        b[:, :256], jnp.ones((625, 256), jnp.float32)),
}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_f32_products_pin_highest_precision(name):
    """On the GPU an unpinned f32 product may run in TF32: every
    dot_general of the f32 decode programs must ask for HIGHEST."""
    text = jax.jit(PROGRAMS[name]).lower(*_model(), _batch()).as_text()
    dots = re.findall(r"stablehlo\.dot_general[^\n]*", text)
    assert dots, "expected matrix products"
    loose = [d for d in dots if "precision = [HIGHEST, HIGHEST]" not in d]
    assert not loose, loose[:2]


def _cache_dir_in_child(env):
    code = ("import jax; from itrails_tpu.utils.cache import "
            "enable_compilation_cache; enable_compilation_cache(); "
            "print(jax.config.jax_compilation_cache_dir)")
    env = {k: v for k, v in env.items() if k != "ITRAILS_NO_CACHE"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("set_env", [True, False])
def test_compilation_cache_directory(tmp_path, set_env):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if set_env:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "xla")
        assert _cache_dir_in_child(env) == str(tmp_path / "xla")
    else:
        assert _cache_dir_in_child(env) == os.path.join(REPO, ".jax_cache")


def test_write_maf_round_trips_ambiguous_tokens(tmp_path):
    from itrails_tpu.data.maf import maf_tokens
    from itrails_tpu.data.simulate import write_maf

    rng = np.random.default_rng(3)
    blocks = [rng.integers(0, 625, size=n).astype(np.int32)
              for n in (5, 300, 17)]
    blocks[0][:] = [0, 255, 256, 600, 624]
    path = str(tmp_path / "a.maf")
    species = ["s1", "s2", "s3", "s4"]
    write_maf(path, blocks, species)
    got = maf_tokens(path, species)
    assert [list(g) for g in got] == [list(b) for b in blocks]


def _run_smoke(cwd, script):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path, alone):
    """No GPU (or no package beside it): a non-zero exit and no result
    line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path, str(script))
    assert out.returncode != 0
    last = (out.stdout.strip().splitlines() or [""])[-1]
    assert '"ok"' not in last
