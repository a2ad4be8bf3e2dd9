"""Native MAF tokenizer parity vs the Python implementation and goldens."""

import os

import numpy as np
import pytest

from itrails_tpu import native
from itrails_tpu.data.maf import maf_reference_coordinates, maf_tokens
from tests.conftest import GOLDENS

SPECIES = ["hg38", "panTro5", "gorGor5", "ponAbe2"]
MAF = os.path.join(GOLDENS, "synthetic.maf")


@pytest.fixture(scope="module")
def lib_ok():
    if not native.available():
        pytest.skip("no C++ toolchain available")


def test_native_tokens_match_python(lib_ok):
    py_blocks = maf_tokens(MAF, SPECIES)
    native_blocks = list(native.maf_tokens_native(MAF, SPECIES))
    assert len(native_blocks) == len(py_blocks)
    for a, b in zip(native_blocks, py_blocks):
        np.testing.assert_array_equal(a, b)


def test_native_coords_match_python(lib_ok):
    py_coords = maf_reference_coordinates(MAF, SPECIES, "hg38")
    pairs = list(native.maf_tokens_native(MAF, SPECIES, ref="hg38"))
    assert len(pairs) == len(py_coords)
    for (toks, coords), ref in zip(pairs, py_coords):
        np.testing.assert_array_equal(coords, ref)


def test_native_throughput_exceeds_python(lib_ok, tmp_path):
    # synthesize a larger MAF (~40k columns over 40 blocks)
    import time

    rng = np.random.default_rng(0)
    path = tmp_path / "big.maf"
    with open(path, "w") as f:
        f.write("##maf version=1\n\n")
        for b in range(40):
            f.write("a score=1\n")
            n = 1000
            for sp in SPECIES:
                s = "".join(rng.choice(list("ACGTacgt-"), size=n))
                f.write(f"s {sp}.chr1 {1000*b} {n} + 5000000 {s}\n")
            f.write("\n")

    t0 = time.time()
    nat = list(native.maf_tokens_native(path, SPECIES))
    t_nat = time.time() - t0
    t0 = time.time()
    py = maf_tokens(path, SPECIES, prefer_native=False)
    t_py = time.time() - t0
    for a, b in zip(nat, py):
        np.testing.assert_array_equal(a, b)
    # the native path should never be slower (usually much faster)
    assert t_nat <= t_py * 1.5, (t_nat, t_py)


def test_native_backtrack_matches_python():
    if not native.backtrack_available():
        import pytest

        pytest.skip("no compiler for native backtrack")
    rng = np.random.default_rng(0)
    n, m = 10_000, 27
    ptrs = rng.integers(0, m, size=(n, m)).astype(np.int32)
    state = 13
    out = native.viterbi_backtrack_native(ptrs, state)
    # serial oracle
    exp = np.empty(n, np.int32)
    s = state
    for t in range(n - 1, -1, -1):
        s = ptrs[t][s]
        exp[t] = s
    np.testing.assert_array_equal(out, exp)


def test_backtrack_walk_used_by_viterbi_long():
    """viterbi_long must produce the decoders.viterbi path after the
    backtrack refactor (native or fallback walk)."""
    import jax.numpy as jnp

    from itrails_tpu.hmm import decoders, longseq

    rng = np.random.default_rng(5)
    m = 9
    a = rng.random((m, m))
    a /= a.sum(1, keepdims=True)
    b = rng.random((m, 256)) * 0.01 + 1e-4
    from itrails_tpu.data.tokens import aggregation_matrix

    bfull = jnp.asarray(b @ aggregation_matrix().T, jnp.float64)
    a = jnp.asarray(a, jnp.float64)
    pi = jnp.asarray(rng.dirichlet(np.ones(m)), jnp.float64)
    tokens = jnp.asarray(rng.integers(0, 625, size=700), jnp.int32)
    ref = np.asarray(decoders.viterbi(a, bfull, pi, tokens[None]))[0]
    out = longseq.viterbi_long(a, bfull, pi, tokens, chunk=64)
    np.testing.assert_array_equal(out, ref)
    seg = longseq.viterbi_segmented(a, bfull, pi, tokens, chunk=32,
                                    seg_chunks=4)
    np.testing.assert_array_equal(seg, ref)
