"""The port's own config loader against the JAX package's, on the CPU: the
same effective dict for every shipped config, the same coercions and the
same unknown-key warnings."""

import glob
import os

import pytest

from vae_channel_dynamics_tpu.utils import config_utils as jcfg
from vae_channel_dynamics_tpu_torch.utils import config_utils as tcfg

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "*.yaml")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_config_matches_jax(path):
    ours = tcfg.load_config(path)
    assert ours == jcfg.load_config(path)
    assert tcfg.warn_unknown_keys(ours) == jcfg.warn_unknown_keys(ours)


def test_defaults_layer_is_a_shallow_merge(tmp_path):
    (tmp_path / "base.yaml").write_text("a: 1\nmodel: {x: 1, y: 2}\n")
    (tmp_path / "exp.yaml").write_text("defaults: [base]\nmodel: {x: 3}\nb: 2\n")
    cfg = tcfg.load_config(str(tmp_path / "exp.yaml"))
    assert cfg == {"a": 1, "model": {"x": 3}, "b": 2}
    assert cfg == jcfg.load_config(str(tmp_path / "exp.yaml"))


def test_missing_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        tcfg.load_config(str(tmp_path / "nope.yaml"))
    (tmp_path / "exp.yaml").write_text("defaults: [absent]\n")
    with pytest.raises(FileNotFoundError, match="Base configuration"):
        tcfg.load_config(str(tmp_path / "exp.yaml"))


def test_empty_document_is_an_empty_config(tmp_path):
    (tmp_path / "empty.yaml").write_text("")
    assert tcfg.load_config(str(tmp_path / "empty.yaml")) == {}


@pytest.mark.parametrize("value", [None, "5e-5", 3, 2.5, "7"])
def test_coercions_match_jax(value):
    assert tcfg.as_float(value, 1.5) == jcfg.as_float(value, 1.5)
    if value != "5e-5" and value != 2.5:
        assert tcfg.as_int(value, 4) == jcfg.as_int(value, 4)


def test_unknown_keys_are_warned_not_dropped():
    cfg = {"model": {"remat": "full", "typo_key": 1}, "trainning": {}, "notes": "x"}
    assert tcfg.warn_unknown_keys(cfg) == ["model.typo_key", "trainning"]
    assert cfg["model"]["typo_key"] == 1
