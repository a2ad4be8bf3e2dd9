"""Compute-resource configuration.

The reference pins BLAS/numba thread counts from a SLURM-aware CPU budget
(reference ncpu.py).  Here the accelerator mesh comes from ``jax.devices()``;
the CPU budget still matters for the host-side model build and data
pipeline, and multi-host runs initialize ``jax.distributed``.
"""

from __future__ import annotations

import multiprocessing as mp
import os

__all__ = ["available_cpus", "update_n_cpu", "init_distributed"]

N_CPU_GLOBAL = None


def available_cpus() -> int:
    """CPU budget: SLURM allocation if present, else all cores
    (reference ncpu.py:5)."""
    return int(os.environ.get("SLURM_JOB_CPUS_PER_NODE", mp.cpu_count()))


def update_n_cpu(user_requested) -> int:
    """Clamp the request to the allocation and pin the numeric libraries'
    thread counts (reference ncpu.py:7-34)."""
    global N_CPU_GLOBAL
    try:
        requested = int(user_requested)
    except (TypeError, ValueError):
        requested = available_cpus()
    n_cpu = min(requested, available_cpus())
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "NUMEXPR_NUM_THREADS"):
        os.environ[var] = str(n_cpu)
    print(f"Using {n_cpu} CPU cores (requested: {requested}, "
          f"available: {available_cpus()}).")
    N_CPU_GLOBAL = n_cpu
    return n_cpu


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Initialize multi-host JAX when running across several hosts.  Arguments default to the standard JAX environment discovery; a
    no-op on a single host with no coordinator configured."""
    import jax

    if coordinator_address is None and "JAX_COORDINATOR_ADDRESS" not in os.environ:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True
