"""Import guard of the PyTorch port: bdm_db1_tpu_torch/ and chip_smoke.py
import no JAX, no flax and nothing of the JAX package, and the port
imports and decodes in a process where JAX cannot be imported."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "flax", "bdm_db1_tpu")


def _sources():
    files = sorted((ROOT / "bdm_db1_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in BANNED


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    bad = [m for m in _imported_modules(path) if _banned(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_sees_a_banned_import(tmp_path):
    src = tmp_path / "x.py"
    src.write_text("import os\nfrom bdm_db1_tpu.core import vocab\n"
                   "from bdm_db1_tpu_torch.core import vocab as ok\n")
    assert [m for m in _imported_modules(src) if _banned(m)] == [
        "bdm_db1_tpu.core"]


def test_port_runs_without_jax():
    """Import every port module, run one tiny CPU decode step and one tiny
    validation loss with JAX made unimportable."""
    code = r'''
import sys
for name in ("jax", "jaxlib", "flax"):
    sys.modules[name] = None
import importlib, pkgutil
import numpy as np, torch
import bdm_db1_tpu_torch
for m in pkgutil.walk_packages(bdm_db1_tpu_torch.__path__, "bdm_db1_tpu_torch."):
    importlib.import_module(m.name)
from bdm_db1_tpu_torch.core.config import db1_tiny
from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
from bdm_db1_tpu_torch.eval.decode import ActionDecoder
torch.set_num_threads(1)
cfg = db1_tiny(dtype="float32", decode_flash="on")
model = TransformerXL(cfg.model, cfg.vocab, device="cpu",
                      generator=torch.Generator().manual_seed(0))
layout = cfg.vocab.layout()
dec = ActionDecoder(model, layout, obs_length=4, action_length=2,
                    discrete_action=False)
prime = np.full((2, 5), layout.continuous_offset, np.int64)
prime[:, -1] = layout.separator_id
act, mems = dec.decode(prime, dec.init_mems(2), defer_last=True)
assert act.shape == (2, 2), act.shape
assert ((act >= layout.continuous_offset) & (act < layout.separator_id)).all()
assert mems["cursor"] == 6
# the validation loss over a packed RL sample, K3's route (plain on the CPU)
from bdm_db1_tpu_torch.data.rl_dataset import (
    RLFullDataset, RLTokenizerSuite, TrajectoryStore, split_rl_dataset)
from bdm_db1_tpu_torch.data.samplers import collate_modalities
from bdm_db1_tpu_torch.eval.envs import FakeContinuousEnv
from bdm_db1_tpu_torch.tokenizers.scalar import ScalarTokenizer
from bdm_db1_tpu_torch.train.trainer import evaluate_loss
cfg = db1_tiny(dtype="float32", n_position=1024, attention_impl="pallas")
model = TransformerXL(cfg.model, cfg.vocab, device="cpu",
                      generator=torch.Generator().manual_seed(0))
store = TrajectoryStore.from_flat_dataset(
    FakeContinuousEnv(5, 2, episode_len=200, seed=1).make_dataset(2))
ds = RLFullDataset("fake", store, RLTokenizerSuite(
    layout, ScalarTokenizer(cfg.vocab.num_continuous_bin)), 1024, seed=0)
valid = split_rl_dataset(ds, "50,50,0")[1]
raw = collate_modalities([valid[0]], ["rl"])
loss = evaluate_loss(model, [{"rl": {k: v[None] for k, v in raw["rl"].items()}}],
                     device="cpu")
assert np.isfinite(loss), loss
assert not any(k in ("jax", "bdm_db1_tpu")
               or k.startswith(("jax.", "flax", "bdm_db1_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("ok")
'''
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("ok")
