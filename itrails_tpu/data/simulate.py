"""Simulate alignments from the coalescent HMM.

Samples a hidden gene-tree path from ``(a, pi)`` and emission columns from
``b``, writing a MAF file — the end-to-end validation loop the reference
lacks entirely (it has no test suite and no simulator): simulate from known
parameters, run ``itrails-tpu-optimize``, check the fit recovers them.
"""

from __future__ import annotations

import numpy as np

from itrails_tpu.data.tokens import token_strings

__all__ = ["simulate_tokens", "simulate_token_batch", "write_maf",
           "simulate_maf"]


def simulate_tokens(model, n_columns: int, seed: int = 0) -> np.ndarray:
    """Sample one block of unambiguous column tokens (indices < 256)."""
    rng = np.random.default_rng(seed)
    a = np.asarray(model.a, dtype=np.float64)
    b = np.asarray(model.b, dtype=np.float64)
    pi = np.asarray(model.pi, dtype=np.float64)
    pi = np.clip(pi, 0, None)
    pi /= pi.sum()
    a = np.clip(a, 0, None)
    a /= a.sum(axis=1, keepdims=True)
    b = np.clip(b, 0, None)
    b /= b.sum(axis=1, keepdims=True)

    m = len(pi)
    # sample the hidden path via inverse-CDF on uniform draws
    cdf_a = np.cumsum(a, axis=1)
    cdf_b = np.cumsum(b, axis=1)
    states = np.empty(n_columns, dtype=np.int64)
    states[0] = rng.choice(m, p=pi)
    u = rng.random(n_columns)
    for t in range(1, n_columns):
        states[t] = np.searchsorted(cdf_a[states[t - 1]], u[t])
    tokens = np.empty(n_columns, dtype=np.int32)
    ue = rng.random(n_columns)
    for t in range(n_columns):
        tokens[t] = np.searchsorted(cdf_b[states[t]], ue[t])
    return tokens, states


def simulate_token_batch(model, n_windows: int, win_len: int, seed: int = 0,
                         n_frac: float = 0.02, n_run: int = 64) -> np.ndarray:
    """Sample a (n_windows, win_len) int32 token batch from the HMM,
    vectorised across windows (one inverse-CDF step per column over all
    windows at once, then per-state grouped emission sampling — tens of
    Mcol in seconds, vs the per-column loop of :func:`simulate_tokens`).

    ``n_frac`` of columns are overwritten by geometric bursts (mean
    ``n_run``) of the all-ambiguous ``NNNN`` token, mimicking the masked
    runs of real MAF alignments (reference read_data.py:94-117 maps every
    non-ACGT character to N) — the realistic-data decode benchmark input.
    """
    rng = np.random.default_rng(seed)
    a = np.clip(np.asarray(model.a, np.float64), 0, None)
    a /= a.sum(axis=1, keepdims=True)
    b = np.clip(np.asarray(model.b, np.float64), 0, None)
    b /= b.sum(axis=1, keepdims=True)
    pi = np.clip(np.asarray(model.pi, np.float64), 0, None)
    pi /= pi.sum()
    m = len(pi)
    cdf_a = np.cumsum(a, axis=1)
    cdf_b = np.cumsum(b, axis=1)

    states = np.empty((n_windows, win_len), dtype=np.int64)
    states[:, 0] = np.minimum(
        np.searchsorted(np.cumsum(pi), rng.random(n_windows)), m - 1
    )
    for t in range(1, win_len):
        u = rng.random(n_windows)
        states[:, t] = np.minimum(
            (cdf_a[states[:, t - 1]] < u[:, None]).sum(axis=1), m - 1
        )

    flat_states = states.reshape(-1)
    u = rng.random(flat_states.size)
    tokens = np.empty(flat_states.size, dtype=np.int32)
    for s in np.unique(flat_states):
        idx = np.nonzero(flat_states == s)[0]
        tokens[idx] = np.minimum(
            np.searchsorted(cdf_b[s], u[idx]), b.shape[1] - 1
        )

    if n_frac > 0.0:
        from itrails_tpu.data.tokens import token_index

        nnnn = token_index()["NNNN"]
        n_runs = max(1, int(n_frac * tokens.size / n_run))
        starts = rng.integers(0, tokens.size, size=n_runs)
        lens = rng.geometric(1.0 / n_run, size=n_runs)
        for s, ln in zip(starts, lens):
            tokens[s:s + ln] = nnnn
    return tokens.reshape(n_windows, win_len)


def write_maf(path, token_blocks, species, chrom="chr1", src_size=500_000_000):
    """Write token blocks (any of the 625 tokens, N-ambiguity included) as a
    minimal MAF alignment."""
    strings = token_strings()
    with open(path, "w") as f:
        f.write("##maf version=1\n\n")
        start = 0
        for block in token_blocks:
            cols = [strings[t] for t in np.asarray(block).tolist()]
            f.write("a score=0.0\n")
            for s, sp in enumerate(species):
                seq = "".join(c[s] for c in cols)
                f.write(f"s {sp}.{chrom} {start} {len(block)} + {src_size} {seq}\n")
            f.write("\n")
            start += len(block)


def simulate_maf(path, model, species, n_blocks=8, block_len=10_000, seed=0):
    """Simulate ``n_blocks`` blocks and write them to ``path``.  Returns the
    sampled hidden-state paths for downstream checks."""
    blocks = []
    paths = []
    for i in range(n_blocks):
        tokens, states = simulate_tokens(model, block_len, seed=seed + i)
        blocks.append(tokens)
        paths.append(states)
    write_maf(path, blocks, species)
    return paths
