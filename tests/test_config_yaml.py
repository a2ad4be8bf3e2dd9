"""The YAML subset reader/writer of itrails_tpu.config against PyYAML, which
serves here only as the oracle: load_yaml must return what yaml.safe_load
returns and dump_yaml must write what yaml.dump writes."""

import glob
import math
import os

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from itrails_tpu import config
from itrails_tpu.config import (FlowSeq, YamlSubsetError, dump_yaml,
                                parse_yaml)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Dumper(yaml.Dumper):
    pass


_Dumper.add_representer(FlowSeq, lambda d, x: d.represent_sequence(
    "tag:yaml.org,2002:seq", x, flow_style=True))


def _pyyaml_dump(data):
    return yaml.dump(data, Dumper=_Dumper)


def _same(x, y):
    """Equality that treats nan as equal to itself."""
    if isinstance(x, float) and isinstance(y, float):
        return x == y or (math.isnan(x) and math.isnan(y))
    if isinstance(x, dict) and isinstance(y, dict):
        return x.keys() == y.keys() and all(_same(x[k], y[k]) for k in x)
    if isinstance(x, list) and isinstance(y, list):
        return len(x) == len(y) and all(map(_same, x, y))
    return type(x) is type(y) and x == y


@pytest.mark.parametrize(
    "path", sorted(glob.glob(os.path.join(REPO, "examples", "*.yaml"))))
def test_example_configs_load_and_dump_like_pyyaml(path):
    text = open(path).read()
    data = parse_yaml(text)
    assert _same(data, yaml.safe_load(text))
    assert data["fixed_parameters"]["mu"] == "1e-8"  # YAML 1.1: a string
    assert dump_yaml(data) == _pyyaml_dump(data)


SETTINGS = {"input_maf": "/data/genome alignments/chr1.maf",
            "output_prefix": "out/run", "species_list": ["hg38", "panTro5",
                                                         "gorGor5", "ponAbe2"],
            "n_int_AB": 3, "n_int_ABC": 3, "method": "Nelder-Mead",
            "n_cpu": None, "reference": "hg38"}
FIXED = {"mu": 1.25e-08, "t_out": 1000000, "N_BC": 40000.0}


@pytest.mark.parametrize("writer", ["starting", "seed", "update"])
def test_checkpoints_match_pyyaml_bytes(tmp_path, writer):
    """The three files the optimize workflow writes, byte for byte."""
    path = str(tmp_path / "f.yaml")
    if writer == "starting":
        bounds = {"t_1": [240000, 24000, 2400000], "r": [1e-08, 1e-09, 1e-07],
                  "m": [0.1, 0.001, 0.99]}
        config.write_starting_params(path, FIXED, bounds, SETTINGS)
        want = {"fixed_parameters": FIXED,
                "optimized_parameters": {k: FlowSeq(v)
                                         for k, v in bounds.items()},
                "settings": {**SETTINGS, "species_list": FlowSeq(
                    SETTINGS["species_list"])}}
    else:
        config.seed_best_model(path, FIXED, SETTINGS)
        want = {"fixed_parameters": FIXED, "optimized_parameters": {},
                "results": {"log_likelihood": -math.inf, "iteration": None},
                "settings": SETTINGS}
        if writer == "update":
            assert config.update_best_model(path, ["t_1", "r", "m"],
                                            [0.0024, 1.0, 0.25], -1234.5, 7)
            mu = FIXED["mu"]
            want["optimized_parameters"] = {"t_1": 0.0024 / mu,
                                            "r": 1.0 * mu, "m": 0.25}
            want["results"] = {"log_likelihood": -1234.5, "iteration": 7}
            assert not config.update_best_model(path, ["t_1"], [1.0],
                                                -2000.0, 8)
    text = open(path).read()
    assert text == _pyyaml_dump(want)
    assert _same(config.load_yaml(path), yaml.safe_load(text))


@pytest.mark.parametrize("text", [
    "a: 1e-8\nb: 1.0e-8\nc: .5\nd: 1.\ne: -.inf\nf: .NaN\n",
    "a: 0x1F\nb: 017\nc: 0b101\nd: 1_000\ne: 1:30\nf: +12\ng: -0\n",
    "a: yes\nb: No\nc: on\nd: OFF\ne: ~\nf: null\ng:\nh: ''\n",
    "a: 'it''s'\nb: \"tab\\there \\u00e9\"\nc: plain text # comment\n",
    "# head\na:  # empty\n  - x\n  - 'y, z'\nb: [1, 'two', 3.0, ~]\nc: []\nd: {}\n",
    "a:\n- 1\n- 2\nb:\n  c:\n    d: deep\n  e: [x,\n    y]\n",
    "long: word word word word word word word word word word word word word\n"
    "  continued here\nq: 'quoted across\n  two lines'\n",
    "'quoted key': 1\n\"dq key\": 2\n?x: 3\n-x: 4\n",
])
def test_reader_matches_safe_load(text):
    assert _same(parse_yaml(text), yaml.safe_load(text))


@pytest.mark.parametrize("text", [
    "a: &anchor 1\nb: *anchor\n",
    "a: !!str 1\n",
    "a: 1\n---\nb: 2\n",
    "a: {b: 1}\n",
    "a: |\n  block\n",
    "a:\n- b: 1\n",
    "a: 2001-12-14\n",
])
def test_reader_rejects_what_lies_outside_the_subset(text):
    with pytest.raises(YamlSubsetError):
        parse_yaml(text)


@pytest.mark.parametrize("data", [
    {"a": "line\nbreak"}, {"a": "caf\u00e9"}, {"": 1}, {"a": [[1]]},
    {"a": [{"b": 1}]}, {"a": (1, 2)}, [1, 2],
])
def test_writer_rejects_what_lies_outside_the_subset(data):
    with pytest.raises(YamlSubsetError):
        dump_yaml(data)


_ALPHABET = list("abcXYZ019 -.:#,'\"[]{}_+?!&*|>%@`=~/\\")
_TEXT = (st.lists(st.sampled_from(_ALPHABET), max_size=40).map("".join)
         | st.sampled_from(["yes", "No", "null", "~", "1e-8", "1.5", "0x1F",
                            "017", "1:30", "2020-01-01", ".inf", "- x",
                            "a: b", " lead", "trail ", "x" * 100 + " y" * 20]))
_SCALAR = (st.none() | st.booleans() | st.integers(-10**9, 10**9)
           | st.floats(allow_nan=False) | _TEXT)
_VALUE = st.recursive(
    _SCALAR | st.lists(_SCALAR, max_size=5)
    | st.lists(_SCALAR, max_size=5).map(FlowSeq),
    lambda inner: st.dictionaries(st.text("abcdefgh_", min_size=1,
                                          max_size=12), inner, max_size=4),
    max_leaves=12)
_DOC = st.dictionaries(st.text("abcdefgh_", min_size=1, max_size=12), _VALUE,
                       max_size=5)


@settings(max_examples=300, deadline=None,
          suppress_health_check=list(HealthCheck))
@given(_DOC)
def test_round_trip_matches_pyyaml(data):
    try:
        text = dump_yaml(data)
    except YamlSubsetError:
        return
    assert text == _pyyaml_dump(data)
    assert _same(parse_yaml(text), yaml.safe_load(text))


def test_no_yaml_import_on_the_main_path():
    import subprocess
    import sys

    code = ("import sys; import itrails_tpu.cli.optimize, "
            "itrails_tpu.cli.viterbi, itrails_tpu.cli.int_posterior, "
            "itrails_tpu.optim.optimizer; "
            "sys.exit('yaml' in sys.modules)")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   env={**os.environ, "JAX_PLATFORMS": "cpu"})
