"""The port's YAML subset reader and load_config against PyYAML and the
JAX package's load_config: every config file, the override values a
command line gives, and the YAML outside the subset (which raises).
Exact equality throughout: values and their Python types."""
import dataclasses
import math
from pathlib import Path

import pytest
import yaml

from pose6d_tpu.config import load_config as jax_load_config
from pose6d_tpu.train.train_step import make_optimizer as jax_make_optimizer
from pose6d_tpu_torch.config import load_config
from pose6d_tpu_torch.models import DPFMNet
from pose6d_tpu_torch.train.train_step import TrainStep
from pose6d_tpu_torch.utils.yaml_subset import safe_load

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "config").glob("*.yaml"))
OVERRIDE_VALUES = [
    "1e-3", "1.0e-3", "0.0005", "-2.5e+3", "1.5E-3", "1.", ".5", "-.5",
    "12e3", "1.0e5", ".inf", "-.Inf", "5", "-1", "+1", "0", "017", "08",
    "0x1F", "0b101", "1_000", "1:30", "null", "~", "", "NULL", "None",
    "true", "False", "yes", "off", "[1, 5]", "[]", "[1, 2,]",
    "[a, 'b', \"c\"]", "{a: 1, b: [1, 2]}", "{render_data_name: x, "
    "mode: train_pbr}", "[{render_data_name: a}, {render_data_name: b}]",
    "'quoted # not a comment'", "\"tab\\there\"", "'it''s'", "synth_obj1",
    "weights/x.msgpack", "http://x.y", "a b c", "1 # a comment",
]
UNSUPPORTED = [
    "&anchor 1", "*alias", "!!str 1", "key: |\n  block", "key: >\n  folded",
    "a: b: c", "- a\nb: 1", "a:\n  b\n  c", "2001-12-14", "<<",
    "a: [1,\n  2]", "---\na: 1", "\ta: 1", "key: - a", "{a}", "a: 'open",
    "? complex\n: key",
]
OVERRIDES = ["train.lr=1e-3", "train.batch_size=4",
             "eval_dataset.num_samples=2", "extra.node.x=1",
             "train_datasets=[{render_data_name: a, min_vis: 0.1}]",
             "model.fmap.n_fmap=20", "pad_v_pc=1024", "target_faces=2000",
             "save_results=null", "train.pretrained=none"]


def same(a, b) -> bool:
    """Equal values of equal types, recursively (NaN equals NaN)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(same, a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_reader_equals_pyyaml_on_config(path):
    text = path.read_text()
    assert same(safe_load(text), yaml.safe_load(text))


@pytest.mark.parametrize("value", OVERRIDE_VALUES)
def test_reader_equals_pyyaml_on_override_value(value):
    assert same(safe_load(value), yaml.safe_load(value))


@pytest.mark.parametrize("doc", UNSUPPORTED)
def test_unsupported_yaml_raises(doc):
    with pytest.raises(ValueError, match="YAML line"):
        safe_load(doc)


def _asdict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["model"].pop("use_flash", None)   # the port has one attention route
    return d


@pytest.mark.parametrize("overrides", [[], OVERRIDES],
                         ids=["plain", "overrides"])
@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_load_config_equals_jax(path, overrides):
    assert same(_asdict(load_config(path, overrides)),
                _asdict(jax_load_config(path, overrides)))


def test_exponent_without_dot_is_a_string_in_both_packages():
    """YAML 1.1 (PyYAML) reads train.lr=1e-3 as the string '1e-3': both
    packages carry it into the config, and both optimizers refuse it
    with a TypeError (JAX's optax RMSprop at its first update, the
    port's torch RMSprop when it is built). 1.0e-3 is a float."""
    cfg_path = ROOT / "config" / "lm_synth.yaml"
    port = load_config(cfg_path, ["train.lr=1e-3"]).train.lr
    ref = jax_load_config(cfg_path, ["train.lr=1e-3"]).train.lr
    assert port == ref == "1e-3"
    assert load_config(cfg_path, ["train.lr=1.0e-3"]).train.lr == 0.001
    import jax.numpy as jnp
    tx = jax_make_optimizer(lr=ref, decay_every_steps=10)
    params = {"w": jnp.ones(3)}
    with pytest.raises(TypeError):
        tx.update({"w": jnp.ones(3)}, tx.init(params), params)
    model = DPFMNet()
    with pytest.raises(TypeError):
        TrainStep(model, load_config(cfg_path).loss, lr=port)
