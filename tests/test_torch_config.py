"""The port's config engine and its YAML subset against PyYAML and the
JAX package's ``core/config.py``.

Every comparison is exact: the same files and overrides must give equal
dicts, and what the port writes must read back equal through
``yaml.safe_load``.
"""

import glob
import math
import os

import pytest
import yaml

import e3d_tpu  # noqa: F401
from e3d_tpu.core import config as jcfg
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.core import config as tcfg
from enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_and_pose_estimation_tpu_torch.core import yamlsubset

CONFIG_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
CONFIG_FILES = sorted(os.path.relpath(p, CONFIG_ROOT) for p in glob.glob(
    os.path.join(CONFIG_ROOT, "**", "*.yaml"), recursive=True))


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_every_config_file_loads_as_pyyaml_does(name):
    path = os.path.join(CONFIG_ROOT, name)
    with open(path, encoding="utf-8") as f:
        want = yaml.safe_load(f)
    assert yamlsubset.load_file(path) == want
    assert tcfg.load_yaml(path) == want


SCALARS = ["1e-5", "1.0e9", "1.0e-6", "5.0e-6", "-.inf", ".NaN", "0x1F",
           "017", "08", "1_000", "1:30", "0b101", "+5", "yes", "Off", "~",
           "null", "", "'a''b'", '"tab\\there \\u00e9"', "[0, 1]", "[]",
           "[[1, 2], [a, 'b c']]", "{}", "it's # a comment", "a#b",
           "/tmp/x y", "${a.b}", "16-mixed", "-"]


@pytest.mark.parametrize("text", SCALARS)
def test_scalars_resolve_as_pyyaml_does(text):
    want = yaml.safe_load(text)
    got = yamlsubset.load(text)
    if isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert got == want and type(got) is type(want)


# The cases of tests/test_config.py, composed by both engines.
COMPOSE_CASES = {
    "defaults": ("default", []),
    "group_reselect": ("default", ["model=large", "dataset=c3vd",
                                   "model.encoder_lr=1e-5",
                                   "dataset.batch_size=6"]),
    "forced_add": ("default", ["++trainer.max_steps=5"]),
    "typed_values": ("default", ["model.cycle_momentum=true",
                                 "model.div_factor=1e9",
                                 "trainer.devices=[0,1]"]),
    "interpolated_run_dir": ("default", ["model=large",
                                         "dataset.batch_size=6"]),
    "test_config": ("test_config", ["dataset=combined"]),
    "pose": ("pose_estimation/pose_estimation", []),
}


@pytest.mark.parametrize("case", sorted(COMPOSE_CASES))
def test_compose_equals_the_jax_compose(case):
    name, overrides = COMPOSE_CASES[case]
    want = jcfg.compose(CONFIG_ROOT, name, overrides)
    got = tcfg.compose(CONFIG_ROOT, name, overrides)
    assert got == want
    if "run_dir_template" in want:
        assert tcfg.run_dir(got, got.run_dir_template) == \
            jcfg.run_dir(want, want.run_dir_template)
    if case == "group_reselect":
        assert got.model.encoder_lr == 1e-5  # "1e-5" cast to float
    with pytest.raises(KeyError):
        tcfg.compose(CONFIG_ROOT, "default", ["trainer.nonexistent=1"])


def test_forward_interpolation_and_cycle():
    cfg = {"run_dir": "${paths.out}",
           "paths": {"root": "/tmp/x", "out": "${paths.root}/exp"},
           "msg": "in ${paths.out} now"}
    tcfg._resolve_interpolations(cfg)
    assert cfg == {"run_dir": "/tmp/x/exp",
                   "paths": {"root": "/tmp/x", "out": "/tmp/x/exp"},
                   "msg": "in /tmp/x/exp now"}
    with pytest.raises(ValueError, match="cycle"):
        tcfg._resolve_interpolations({"a": "${b}", "b": "${a}"})


@pytest.mark.parametrize("overrides", [
    ["model=base"],
    ["model=large", "model.encoder_lr=1e-5", "++trainer.max_steps=2",
     "dataset.data_dir=/tmp/a b", "++extra.flag=null",
     "++extra.text='quoted: yes'", "trainer.devices=[]"],
], ids=["base", "mixed"])
def test_snapshot_reads_back_through_pyyaml(overrides, tmp_path):
    cfg = tcfg.compose(CONFIG_ROOT, "default", overrides)
    tcfg.snapshot(cfg, str(tmp_path))
    with open(tmp_path / "config.yaml", encoding="utf-8") as f:
        config = yaml.safe_load(f)
    with open(tmp_path / "overrides.yaml", encoding="utf-8") as f:
        assert yaml.safe_load(f) == overrides
    assert config == {k: v for k, v in cfg.to_plain().items()
                      if k not in ("_groups_", "_overrides_")}
    assert yamlsubset.load_file(str(tmp_path / "config.yaml")) == config


OUTSIDE = {"block scalar": "a: |\n  text\n",
           "anchor": "a: &x 1\nb: *x\n",
           "tag": "a: !!str 1\n",
           "multi-line plain": "a: b\n  c\n",
           "flow mapping": "a: {b: 1}\n",
           "document marker": "---\na: 1\n",
           "complex key": "? a\n: b\n",
           "inline mapping": "a: b: c\n",
           "multi-line flow": "a: [1,\n  2]\n",
           "merge key": "<<: 1\n",
           "timestamp": "d: 2001-12-14\n",
           "tab indent": "a:\n\tb: 1\n"}


@pytest.mark.parametrize("kind", sorted(OUTSIDE))
def test_constructs_outside_the_subset_raise_with_file_and_line(kind,
                                                                tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text("# header\n" + OUTSIDE[kind], encoding="utf-8")
    with pytest.raises(yamlsubset.YamlSubsetError,
                       match=rf"^{path}:[23]: "):
        tcfg.load_yaml(str(path))
