"""Weak-scaling harness for the sharded forward decode.

Runs the production data-parallel log-likelihood (hmm.sharding) with FIXED
per-device work over meshes of 1/2/4/8 devices and reports per-device
throughput + weak-scaling efficiency as JSON (``--out``, default
WEAKSCALING.json in the current directory).

With ``--backend cpu`` (the default) each measurement runs on N CPU devices
(fresh subprocess per N — XLA's device count is fixed at backend init).
With ``--backend gpu`` each measurement is one worker process driving the
first N GPUs of the host; the parent never opens a card, so every card has
one process at a time.  The collective pattern is identical either way: one
psum of the per-shard scalar (see hmm/sharding.py).

    python tools/weak_scaling.py --backend gpu --sizes 1,2,4
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pin_cores(n_dev: int) -> int:
    """Pin this process to ``n_dev`` cores (one per virtual device) so
    per-device compute is CONSTANT across mesh sizes — without this, N
    virtual devices share every core and per-device throughput decays
    ~1/N by construction, which says nothing about the collective path.
    Returns the number of cores actually pinned (0 if unsupported)."""
    try:
        cores = sorted(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        return 0
    if n_dev > len(cores):
        return -1  # cannot isolate: more devices than cores
    os.sched_setaffinity(0, set(cores[:n_dev]))
    return n_dev


def measure_proc(pid: int, nproc: int, port: str, w_per_dev: int,
                 t_len: int, m: int):
    """One process of the process-isolated measurement: a single-device CPU
    backend pinned to ONE core, joined to an ``nproc``-process global mesh
    over ``jax.distributed`` loopback (Gloo).  Unlike the virtual-device
    mode, per-device compute here runs on a genuinely private core and the
    final psum crosses a real inter-process collective — the same pattern
    as N hosts joined by a network."""
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cores[pid % len(cores)]})
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    if nproc > 1:
        jax.distributed.initialize(
            coordinator_address=f"127.0.0.1:{port}",
            num_processes=nproc, process_id=pid,
        )
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from itrails_tpu.hmm import sharding

    devs = jax.devices()
    mesh = sharding.data_mesh(devs)
    n_dev = len(devs)
    assert n_dev == nproc, (n_dev, nproc)

    rng = np.random.default_rng(0)
    a = rng.random((m, m))
    a /= a.sum(1, keepdims=True)
    bfull = rng.random((m, 625)) * 0.01 + 1e-4
    pi = rng.random(m)
    pi /= pi.sum()
    cast = jnp.float32
    a, bfull, pi = (jnp.asarray(x, cast) for x in (a, bfull, pi))
    repl = NamedSharding(mesh, P())
    a, bfull, pi = (jax.device_put(x, repl) for x in (a, bfull, pi))

    w = nproc * w_per_dev
    tokens_np = rng.integers(0, 625, size=(w, t_len)).astype(np.int32)
    sh = NamedSharding(mesh, P("data", None))
    tokens = jax.make_array_from_callback(
        (w, t_len), sh, lambda idx: tokens_np[idx]
    )
    f = sharding.sharded_loglik_fn(mesh)
    jax.block_until_ready(f(a, bfull, pi, tokens))  # compile
    jax.block_until_ready(f(a, bfull, pi, tokens))
    n_rep = 3
    t0 = time.time()
    for _ in range(n_rep):
        ll = f(a, bfull, pi, tokens)
    jax.block_until_ready(ll)
    dt = (time.time() - t0) / n_rep
    cols = w * t_len
    return {
        "n_devices": nproc,
        "windows": w,
        "t_len": t_len,
        "cols": cols,
        "seconds": dt,
        "cols_per_s": cols / dt,
        "cols_per_s_per_device": cols / dt / nproc,
        "loglik": float(ll),
        "isolation": "1 process = 1 pinned core = 1 device; "
                     "psum over jax.distributed (Gloo loopback)",
    }


def measure(n_dev: int, w_per_dev: int, t_len: int, m: int):
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from itrails_tpu.hmm import sharding

    devices = jax.devices()[:n_dev]
    assert len(devices) == n_dev, f"need {n_dev} devices, have {len(devices)}"
    mesh = sharding.data_mesh(devices)

    rng = np.random.default_rng(0)
    a = rng.random((m, m))
    a /= a.sum(1, keepdims=True)
    bfull = rng.random((m, 625)) * 0.01 + 1e-4
    pi = rng.random(m)
    pi /= pi.sum()
    cast = jnp.float32
    a, bfull, pi = (jnp.asarray(x, cast) for x in (a, bfull, pi))

    w = n_dev * w_per_dev
    tokens = jnp.asarray(
        rng.integers(0, 625, size=(w, t_len)), jnp.int32
    )
    tokens = sharding.shard_batch(tokens, mesh)
    f = sharding.sharded_loglik_fn(mesh)
    jax.block_until_ready(f(a, bfull, pi, tokens))  # compile
    jax.block_until_ready(f(a, bfull, pi, tokens))
    n_rep = 3
    t0 = time.time()
    for _ in range(n_rep):
        ll = f(a, bfull, pi, tokens)
    jax.block_until_ready(ll)
    dt = (time.time() - t0) / n_rep
    cols = w * t_len
    return {
        "n_devices": n_dev,
        "windows": w,
        "t_len": t_len,
        "cols": cols,
        "seconds": dt,
        "cols_per_s": cols / dt,
        "cols_per_s_per_device": cols / dt / n_dev,
        "loglik": float(ll),
    }


def dryrun(runbook_path):
    """Validate the complete multi-device plumbing end to end — worker
    subprocess spawn, env/flag propagation, mesh construction, sharded
    decode, RESULT parsing — on an 8-virtual-device CPU mesh with tiny
    shapes, then write the runbook artifact to ``runbook_path``.  Green
    here means the only untested step on a GPU host is the hardware
    itself."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", "8",
           "--backend", "cpu", "--w-per-dev", "4", "--t-len", "256",
           "--m", "27", "--no-pin"]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=900)
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("RESULT ")]
    if not lines:
        raise RuntimeError(f"dryrun worker failed:\n{out.stdout[-2000:]}\n"
                           f"{out.stderr[-2000:]}")
    res = json.loads(lines[-1][len("RESULT "):])
    assert res["n_devices"] == 8, res
    assert res["windows"] == 32 and res["t_len"] == 256, res
    import math

    assert math.isfinite(res["loglik"]) and res["loglik"] < 0.0, res
    runbook = {
        "validated": "8-virtual-device CPU mesh: worker spawn, env/flag "
                     "plumbing, mesh + sharded decode + RESULT parsing all "
                     "green (this artifact is written only on success)",
        "dryrun_result": res,
        "gpu_commands": {
            "one host, N cards": (
                "python tools/weak_scaling.py --backend gpu "
                "--sizes 1,2,4 --w-per-dev 512 --t-len 8192"
            ),
            "env": {"PYTHONPATH": "<repo root>"},
        },
        "expected": {
            "per_device_mcols_per_s": "not measured",
            "weak_scaling_efficiency": ">= 0.95 — the decode communicates "
                                       "ONE scalar psum per eval "
                                       "(hmm/sharding.py)",
        },
    }
    path = runbook_path
    with open(path, "w") as f:
        json.dump(runbook, f, indent=1)
    print(f"DRYRUN OK: 8 virtual devices, loglik {res['loglik']:.1f}; "
          f"wrote {path}")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--worker", type=int, default=None,
                   help="(internal) run one measurement at N devices")
    p.add_argument("--proc-worker", type=str, default=None,
                   help="(internal) 'pid,nproc,port' for one process of the "
                        "process-isolated mode")
    p.add_argument("--mode", choices=["virtual", "procs"], default="procs",
                   help="procs: N pinned single-device processes over "
                        "jax.distributed loopback (true isolation; default); "
                        "virtual: N virtual devices in one process")
    p.add_argument("--backend", choices=["cpu", "gpu"], default="cpu")
    p.add_argument("--w-per-dev", type=int, default=64)
    p.add_argument("--t-len", type=int, default=4096)
    p.add_argument("--m", type=int, default=27)
    p.add_argument("--sizes", type=str, default=None,
                   help="mesh sizes; cpu default: powers of 2 up to the "
                        "core count (isolable), gpu default: 1,2,4")
    p.add_argument("--pin", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="pin each cpu worker to n_dev disjoint cores "
                        "(one core per virtual device)")
    p.add_argument("--out", type=str, default="WEAKSCALING.json")
    p.add_argument("--runbook", type=str, default="WEAKSCALING_RUNBOOK.json",
                   help="where --dryrun writes its runbook artifact")
    p.add_argument("--dryrun", action="store_true",
                   help="validate the full multi-device arg plumbing on an "
                        "8-virtual-device CPU mesh (tiny shapes, no "
                        "pinning) and write the runbook artifact — the "
                        "ready-to-run commands and env for a GPU host")
    args = p.parse_args()

    if args.dryrun:
        return dryrun(args.runbook)

    if args.proc_worker is not None:
        pid, nproc, port = args.proc_worker.split(",")
        res = measure_proc(int(pid), int(nproc), port,
                           args.w_per_dev, args.t_len, args.m)
        if int(pid) == 0:
            print("RESULT " + json.dumps(res))
        return

    if args.worker is not None:
        pinned = 0
        if args.backend == "cpu":
            os.environ["JAX_PLATFORMS"] = "cpu"
            if args.pin:
                pinned = pin_cores(args.worker)
                if pinned < 0:
                    print("RESULT " + json.dumps(
                        {"n_devices": args.worker, "skipped":
                         "more devices than physical cores; cannot isolate"}
                    ))
                    return
            import jax

            jax.config.update("jax_platforms", "cpu")
        res = measure(args.worker, args.w_per_dev, args.t_len, args.m)
        res["cores_pinned"] = pinned
        print("RESULT " + json.dumps(res))
        return

    if args.mode == "procs" and args.backend == "cpu":
        n_cores = len(os.sched_getaffinity(0))
        if args.sizes:
            sizes = [int(s) for s in args.sizes.split(",")]
        else:
            sizes = [n for n in (1, 2, 4, 8) if n <= n_cores]
        rows = []
        for n in sizes:
            env = dict(os.environ)
            env["PYTHONPATH"] = REPO + (
                os.pathsep + env["PYTHONPATH"]
                if env.get("PYTHONPATH") else ""
            )
            port = str(12731 + n)
            procs = [
                subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--proc-worker", f"{pid},{n},{port}",
                     "--w-per-dev", str(args.w_per_dev),
                     "--t-len", str(args.t_len), "--m", str(args.m)],
                    env=env, stdout=subprocess.PIPE, text=True)
                for pid in range(n)
            ]
            outs = [pr.communicate(timeout=900)[0] for pr in procs]
            if any(pr.returncode for pr in procs):
                raise RuntimeError(
                    f"proc-worker n={n} failed: {outs}")
            line = [ln for out in outs for ln in out.splitlines()
                    if ln.startswith("RESULT ")]
            rows.append(json.loads(line[-1][len("RESULT "):]))
            print(f"n={n}: {rows[-1]['cols_per_s_per_device']/1e6:.2f} "
                  f"Mcol/s/device")
        base = rows[0]["cols_per_s_per_device"]
        for r in rows:
            r["weak_scaling_efficiency"] = r["cols_per_s_per_device"] / base
        report = {
            "metric": "weak scaling of sharded forward loglik "
                      "(fixed per-device work)",
            "expectation": (
                "one jitted shard_map per device with a SINGLE psum of a "
                "per-shard scalar (hmm/sharding.py) — O(1) scalars of "
                "communication per eval, so weak scaling should be "
                "near-flat on real hardware"
            ),
            "mode": "process-isolated: each of N processes owns ONE pinned "
                    "core and ONE cpu device; the psum crosses "
                    "jax.distributed (Gloo loopback) as it would cross a "
                    "network between hosts",
            "caveat": f"this host exposes {n_cores} cores, so mesh sizes "
                      f"beyond {n_cores} are not isolable here; run "
                      "--backend gpu on a GPU host for hardware numbers",
            "backend": "cpu",
            "m_states": args.m,
            "w_per_dev": args.w_per_dev,
            "t_len": args.t_len,
            "rows": rows,
        }
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}")
        return

    if args.sizes:
        sizes = [int(s) for s in args.sizes.split(",")]
    elif args.backend == "cpu" and args.pin:
        n_cores = len(os.sched_getaffinity(0))
        sizes = [n for n in (1, 2, 4, 8) if n <= n_cores]
    else:
        sizes = [1, 2, 4]
    rows = []
    for n in sizes:
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
        )
        if args.backend == "cpu":
            env["JAX_PLATFORMS"] = "cpu"
            env["XLA_FLAGS"] = (
                f"--xla_force_host_platform_device_count={n}"
            )
        cmd = [sys.executable, os.path.abspath(__file__),
               "--worker", str(n), "--backend", args.backend,
               "--w-per-dev", str(args.w_per_dev),
               "--t-len", str(args.t_len), "--m", str(args.m)]
        if not args.pin:
            cmd.append("--no-pin")
        out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=900)
        line = [ln for ln in out.stdout.splitlines()
                if ln.startswith("RESULT ")]
        if not line:
            raise RuntimeError(
                f"weak-scaling worker n={n} failed:\n{out.stdout[-2000:]}"
                f"\n{out.stderr[-2000:]}"
            )
        rows.append(json.loads(line[-1][len("RESULT "):]))
        print(f"n={n}: {rows[-1]['cols_per_s_per_device']/1e6:.2f} "
              f"Mcol/s/device")

    scored = [r for r in rows if "cols_per_s_per_device" in r]
    base = scored[0]["cols_per_s_per_device"]
    for r in scored:
        r["weak_scaling_efficiency"] = r["cols_per_s_per_device"] / base
    report = {
        "metric": "weak scaling of sharded forward loglik "
                  "(fixed per-device work)",
        "expectation": (
            "the decode is one jitted pmap-style shard per device with a "
            "SINGLE psum of a per-shard scalar at the end (hmm/sharding.py)"
            " — communication per eval is O(1) scalars, so weak scaling "
            "should be near-flat on real hardware"
        ),
        "caveat": (
            "backend=cpu: each worker is affinity-pinned to n_dev disjoint "
            "cores (one core per virtual device) so per-device compute is "
            "constant across mesh sizes; sizes beyond the physical core "
            "count are skipped as not isolable.  Run --backend gpu on a "
            "GPU host for hardware numbers."
            if args.backend == "cpu" and args.pin else
            "backend=cpu without pinning: N virtual devices share every "
            "core, so per-device throughput decays ~1/N by construction."
            if args.backend == "cpu" else ""
        ),
        "backend": args.backend,
        "pinned": bool(args.pin) if args.backend == "cpu" else None,
        "m_states": args.m,
        "w_per_dev": args.w_per_dev,
        "t_len": args.t_len,
        "rows": rows,
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
