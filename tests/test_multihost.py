"""N>=2-process distributed correctness: sharded loglik / posterior /
long-block decode across two ``jax.distributed`` loopback processes match
the single-process values (BASELINE.md gate: parity at "N>=2 hosts")."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "multihost_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _reference_values():
    """Single-process values for the worker's deterministic computation."""
    import jax
    import jax.numpy as jnp

    from itrails_tpu.hmm import decoders

    m = 9
    rng = np.random.default_rng(0)
    a = rng.random((m, m))
    a /= a.sum(1, keepdims=True)
    bfull = rng.random((m, 625)) * 0.01 + 1e-4
    pi = rng.random(m)
    pi /= pi.sum()
    a, bfull, pi = jnp.asarray(a), jnp.asarray(bfull), jnp.asarray(pi)

    n_dev = 4  # 2 processes x 2 forced-host devices
    w, t = 2 * n_dev, 300
    tokens = jnp.asarray(rng.integers(0, 625, size=(w, t)), jnp.int32)
    ll = float(decoders.forward_loglik(a, bfull, pi, tokens))
    post = decoders.posterior(a, bfull, pi, tokens)
    wvec = jnp.asarray(rng.random((m,)))
    ps = float(jnp.sum(post * wvec))
    long_tok = jnp.asarray(rng.integers(0, 625, size=(8192,)), jnp.int32)
    ll_long = float(decoders.forward_loglik(a, bfull, pi, long_tok[None, :]))
    rng_e = np.random.default_rng(7)
    v_lst = [rng_e.integers(0, 625, size=n).astype(np.int64)
             for n in (150, 5000, 700, 300, 120, 80, 2000, 90)]
    ll_engine = sum(
        float(decoders.forward_loglik(a, bfull, pi,
                                      jnp.asarray(v)[None, :]))
        for v in v_lst
    )
    return ll, ps, ll_long, ll_engine


@pytest.mark.slow
def test_two_process_distributed_matches_single(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    procs = []
    outs = []
    for pid in range(2):
        out = str(tmp_path / f"worker{pid}.json")
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", str(port), out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ))
    logs = []
    for p in procs:
        stdout, _ = p.communicate(timeout=600)
        logs.append(stdout.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"

    ll_ref, ps_ref, ll_long_ref, ll_eng_ref = _reference_values()
    for out in outs:
        res = json.load(open(out))
        assert res["n_dev"] == 4  # global mesh spans both processes
        np.testing.assert_allclose(res["ll"], ll_ref, rtol=1e-10)
        np.testing.assert_allclose(res["post_stat"], ps_ref, rtol=1e-8)
        np.testing.assert_allclose(res["ll_long"], ll_long_ref, rtol=1e-8)
        # the production engine layout (buckets + long routing) across both
        # processes (BASELINE config 5's mixed whole-genome shape)
        np.testing.assert_allclose(res["ll_engine"], ll_eng_ref, rtol=1e-8)


def test_weak_scaling_dryrun(tmp_path):
    """tools/weak_scaling.py --dryrun: the multi-device arg plumbing runs
    green on an 8-virtual-device mesh and writes the runbook artifact where
    --runbook says (never into the checkout)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    art = str(tmp_path / "runbook.json")
    out = subprocess.run(
        [sys.executable, os.path.join(repo, "tools", "weak_scaling.py"),
         "--dryrun", "--runbook", art],
        capture_output=True, text=True, timeout=600, cwd=tmp_path,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "DRYRUN OK" in out.stdout
    assert os.path.exists(art)
    res = json.load(open(art))["dryrun_result"]
    assert res["n_devices"] == 8 and res["loglik"] < 0
