"""Model-artifact disk cache (utils/cache.py): exact-parameter rebuilds
are served bit-identically across processes; any parameter/topology/dtype
change is a clean miss.  (The reference has no build cache at all — every
workflow_*.py call pays the full trans_emiss_calc, optimizer.py:396-414.)"""

import os

import numpy as np
import pytest

from itrails_tpu.core.model import build_model
from itrails_tpu.utils import cache as ucache

PARAMS = dict(
    t_A=0.0024, t_B=0.0024, t_C=0.0028, t_2=0.0004, t_upper=0.00745069,
    t_out=0.009312, N_AB=0.0005, N_ABC=0.0005, r=1.0,
)


@pytest.fixture
def cache_env(tmp_path, monkeypatch):
    monkeypatch.delenv("ITRAILS_NO_CACHE", raising=False)
    monkeypatch.setenv("ITRAILS_CACHE_DIR", str(tmp_path))
    return tmp_path


def test_artifact_roundtrip_bit_identical(cache_env):
    m1 = build_model(**PARAMS, n_int_AB=1, n_int_ABC=1, dtype="float64",
                     device="cpu")
    files = list((cache_env / "models").glob("*.npz"))
    assert len(files) == 1, "build should store one artifact"
    m2 = build_model(**PARAMS, n_int_AB=1, n_int_ABC=1, dtype="float64",
                     device="cpu")
    for x, y in ((m1.a, m2.a), (m1.b, m2.b), (m1.pi, m2.pi),
                 (m1.cut_AB, m2.cut_AB), (m1.cut_ABC, m2.cut_ABC)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert m1.hidden_states == m2.hidden_states
    # the hit did not write a second artifact
    assert len(list((cache_env / "models").glob("*.npz"))) == 1


def test_key_sensitivity():
    base = ucache.model_artifact_key("plain", 1, 1, "float64",
                                     list(PARAMS.values()))
    bumped = dict(PARAMS)
    bumped["t_A"] = np.nextafter(PARAMS["t_A"], 1.0)  # 1-ulp change
    assert ucache.model_artifact_key(
        "plain", 1, 1, "float64", list(bumped.values())) != base
    assert ucache.model_artifact_key(
        "int", 1, 1, "float64", list(PARAMS.values())) != base
    assert ucache.model_artifact_key(
        "plain", 1, 2, "float64", list(PARAMS.values())) != base
    assert ucache.model_artifact_key(
        "plain", 1, 1, "float32", list(PARAMS.values())) != base
    assert ucache.model_artifact_key(
        "plain", 1, 1, "float64", list(PARAMS.values()),
        cut_AB=[0.0, 0.1]) != base


def test_no_cache_env_opts_out(cache_env, monkeypatch):
    monkeypatch.setenv("ITRAILS_NO_CACHE", "1")
    build_model(**PARAMS, n_int_AB=1, n_int_ABC=1, dtype="float64",
                device="cpu")
    assert not (cache_env / "models").exists()


def test_corrupt_artifact_falls_back_to_build(cache_env):
    m1 = build_model(**PARAMS, n_int_AB=1, n_int_ABC=1, dtype="float64",
                     device="cpu")
    (path,) = (cache_env / "models").glob("*.npz")
    path.write_bytes(b"not an npz")
    m2 = build_model(**PARAMS, n_int_AB=1, n_int_ABC=1, dtype="float64",
                     device="cpu")
    np.testing.assert_allclose(np.asarray(m1.a), np.asarray(m2.a),
                               rtol=0, atol=0)


def test_lru_prune(cache_env, monkeypatch):
    monkeypatch.setattr(ucache, "_ARTIFACT_KEEP", 3)
    for k in range(5):
        ucache.model_artifact_put(f"key{k}", np.zeros(2), np.zeros(2),
                                  np.zeros(2), np.zeros(2), np.zeros(2))
    names = {p.name for p in (cache_env / "models").glob("*.npz")}
    assert len(names) == 3 and "key4.npz" in names


def test_artifact_hit_arrays_are_uncommitted(cache_env):
    """Regression (caught by an end-to-end CLI smoke on an accelerator):
    the artifact-hit path must return UNCOMMITTED arrays like the jit build
    path does — an explicit device_put commits them, and a later sharded
    decode mixing them with accelerator-placed tokens raises
    'incompatible devices'.  Proxy check on the virtual mesh: a hit-path
    table must be consumable in one jit together with an array committed
    to a DIFFERENT device."""
    import jax
    import jax.numpy as jnp

    build_model(**PARAMS, n_int_AB=1, n_int_ABC=1, dtype="float64",
                device="cpu")  # populate
    m = build_model(**PARAMS, n_int_AB=1, n_int_ABC=1, dtype="float64",
                    device="cpu")  # artifact hit
    devs = jax.devices()
    if len(devs) < 2:
        import pytest

        pytest.skip("needs >= 2 devices (virtual mesh)")
    other = jax.device_put(jnp.ones((4,), m.a.dtype), devs[1])
    # committed-to-dev0 a + committed-to-dev1 other would raise here
    out = jax.jit(lambda a, x: a.sum() + x.sum())(m.a, other)
    assert jnp.isfinite(out)
