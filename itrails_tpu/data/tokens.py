"""Observed-state alphabet for 4-species alignment columns.

625 tokens: the 256 unambiguous ACTG 4-mers (index = a*64+b*16+c*4+d over
the alphabet A,C,T,G) followed by the 369 4-mers containing at least one N
(enumeration order of the reference's get_obs_state_dct,
read_data.py:6-24).  Ambiguity (N / gap / unknown) is resolved by summing
the emission probability over the compatible unambiguous tokens; the
reference does this with a recursive per-token index-set lookup
(read_data.py:46-67) applied inside every HMM step — here it is a static
(625, 256) 0/1 aggregation matrix applied once per model build:
``b_full = b @ AGG.T``.
"""

from __future__ import annotations

import functools

import numpy as np

ALPHABET = "ACTG"
PAD_TOKEN = -1

__all__ = ["ALPHABET", "PAD_TOKEN", "token_strings", "token_index",
           "aggregation_matrix", "tokenize_column"]


@functools.lru_cache(maxsize=1)
def token_strings() -> list:
    """All 625 token strings in reference order."""
    out = [a + b + c + d for a in ALPHABET for b in ALPHABET
           for c in ALPHABET for d in ALPHABET]
    ext = "ACTGN"
    for a in ext:
        for b in ext:
            for c in ext:
                for d in ext:
                    s = a + b + c + d
                    if "N" in s:
                        out.append(s)
    return out


@functools.lru_cache(maxsize=1)
def token_index() -> dict:
    return {s: i for i, s in enumerate(token_strings())}


@functools.lru_cache(maxsize=1)
def aggregation_matrix() -> np.ndarray:
    """(625, 256) 0/1 matrix: row t marks the unambiguous tokens compatible
    with token t (N matches any base)."""
    strings = token_strings()
    agg = np.zeros((len(strings), 256), dtype=np.float64)
    base_idx = {c: i for i, c in enumerate(ALPHABET)}
    for t, s in enumerate(strings):
        choices = [range(4) if ch == "N" else [base_idx[ch]] for ch in s]
        for a in choices[0]:
            for b in choices[1]:
                for c in choices[2]:
                    for d in choices[3]:
                        agg[t, ((a * 4 + b) * 4 + c) * 4 + d] = 1.0
    return agg


def tokenize_column(column: str) -> int:
    """Token index of one alignment column (gaps and unknown chars -> N)."""
    clean = "".join(
        ch if ch in "ACTGN" else "N" for ch in column.upper().replace("-", "N")
    )
    return token_index()[clean]


# --- 3-species ("new method") alphabet -------------------------------------
# The reference carries an unused alternative observation model over
# (species1, species2, outgroup) 3-mers: 64 unambiguous + 61 N-containing
# = 125 tokens (read_data.py:27-43, 70-91; loglik wrappers at
# optimizer.py:68-91).  Provided for feature parity.


@functools.lru_cache(maxsize=1)
def token_strings_3() -> list:
    out = [a + b + d for a in ALPHABET for b in ALPHABET for d in ALPHABET]
    ext = "ACTGN"
    for a in ext:
        for b in ext:
            for d in ext:
                s = a + b + d
                if "N" in s:
                    out.append(s)
    return out


@functools.lru_cache(maxsize=1)
def token_index_3() -> dict:
    return {s: i for i, s in enumerate(token_strings_3())}


@functools.lru_cache(maxsize=1)
def aggregation_matrix_3() -> np.ndarray:
    """(125, 64) ambiguity-resolution matrix for the 3-species alphabet."""
    strings = token_strings_3()
    agg = np.zeros((len(strings), 64), dtype=np.float64)
    base_idx = {c: i for i, c in enumerate(ALPHABET)}
    for t, s in enumerate(strings):
        choices = [range(4) if ch == "N" else [base_idx[ch]] for ch in s]
        for a in choices[0]:
            for b in choices[1]:
                for d in choices[2]:
                    agg[t, (a * 4 + b) * 4 + d] = 1.0
    return agg
