"""The port's config copy (bdm_db1_tpu_torch/core/config.py) against the JAX
package's: every field of each section with the same default, the two
named configs equal section for section, the JSON round trip across the
two packages and the command line parsed to the same config."""

import dataclasses
import json

import pytest

from bdm_db1_tpu.core import config as jc
from bdm_db1_tpu_torch.core import config as tc


def _fields(cls):
    """{name: (default, default factory)}; a factory that is a config class
    compares by name (each package has its own class)."""
    return {f.name: (f.default, getattr(f.default_factory, "__name__",
                                        f.default_factory))
            for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("name", ["VocabConfig", "VisionConfig",
                                  "ModelConfig", "DataConfig", "EvalConfig",
                                  "OptimizerConfig", "TrainConfig",
                                  "MeshConfig", "DB1Config"])
def test_section_fields_match_jax(name):
    assert _fields(getattr(tc, name)) == _fields(getattr(jc, name))


@pytest.mark.parametrize("name", ["db1_tiny", "db1_1p2b"])
def test_named_configs_match_jax(name):
    j, t = getattr(jc, name)(), getattr(tc, name)()
    for section in ("model", "vocab", "vision", "mesh", "train", "data",
                    "eval"):
        assert dataclasses.asdict(getattr(t, section)) == \
            dataclasses.asdict(getattr(j, section)), section
    tl, jl = t.vocab.layout(), j.vocab.layout()
    for attr in ("discrete_offset", "continuous_offset", "separator_id",
                 "total_vocab_size", "padded_vocab_size"):
        assert getattr(tl, attr) == getattr(jl, attr), attr
    assert t.model.d_head == j.model.d_head
    assert t.model.d_inner == j.model.d_inner


def _edited(pkg, name):
    """A named config with one field of every section off its default."""
    cfg = getattr(pkg, name)()
    cfg.model.n_layer = 3
    cfg.vocab.discretize_mu = 50.0
    cfg.vision.image_size = 64
    cfg.mesh.axis_names = ("dp", "tp")
    cfg.mesh.multihost = False
    cfg.train.optimizer.adam_mu_dtype = "bfloat16"
    cfg.train.save_dir = "/ckpt"
    cfg.data.data_path = ("1", "a", "rl")
    cfg.eval.env_names = ("e1", "e2")
    cfg.eval.max_step_size = 7
    return cfg


@pytest.mark.parametrize("name", ["db1_tiny", "db1_1p2b"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_json_round_trip_across_packages(name, writer, tmp_path):
    """A JSON written by either package loads in both to the same config,
    and writing it again gives the same JSON."""
    src, dst = (jc, tc) if writer == "jax" else (tc, jc)
    path = tmp_path / "cfg.json"
    _edited(src, name).to_json(str(path))
    want = _edited(src, name).to_dict()
    for pkg in (src, dst):
        cfg = pkg.DB1Config.from_json(str(path))
        assert cfg.to_dict() == want
        assert cfg == pkg.DB1Config.from_dict(json.loads(path.read_text()))
        again = tmp_path / f"{pkg.__name__}.json"
        cfg.to_json(str(again))
        assert json.loads(again.read_text()) == json.loads(path.read_text())


@pytest.mark.parametrize("argv", [
    [],
    ["--model.n-layer", "4", "--model.dtype", "float32",
     "--model.n-inner", "128"],
    ["--eval.env-names", "a-v0", "b-v0", "--eval.batched", "false",
     "--eval.max-step-size", "8", "--eval.decode-obs-buckets", "0"],
    ["--train.load-dir", "/ckpts", "--train.ckpt-tag", "tag",
     "--train.optimizer.lr", "3e-4", "--train.optimizer.fused", "true",
     "--mesh.multihost", "false", "--mesh.axis-names", "x", "y"],
    ["--data.data-path", "0.5", "c", "rl", "--vocab.overlap-with-text",
     "False", "--vision.patch-size", "8"],
])
def test_from_cli_matches_jax(argv):
    assert tc.DB1Config.from_cli(argv).to_dict() == \
        jc.DB1Config.from_cli(argv).to_dict()


def test_from_cli_reads_a_config_file(tmp_path):
    path = tmp_path / "cfg.json"
    jc.db1_1p2b().to_json(str(path))
    argv = ["--config", str(path), "--eval.num-trials", "20"]
    cfg = tc.DB1Config.from_cli(argv)
    assert cfg.model.n_embed == 2048 and cfg.eval.num_trials == 20
    assert cfg.to_dict() == jc.DB1Config.from_cli(argv).to_dict()
