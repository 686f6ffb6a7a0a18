"""Checkpointing with resume in the port (bdm_db1_tpu_torch/train/checkpoint.py
and the Trainer's use of it), on the CPU at db1_tiny in f32: the round
trip of the whole train state, pruning, a resumed Trainer bitwise equal to
the uninterrupted one, the emergency checkpoint on a crash, and the
Trainer's checkpoint steps, client state and metric keys against the JAX
package's; the asynchronous save (the state of the call written while the
state moves on, no unfinished step visible, a failed write raised at
``wait``), its writer held on a ``threading.Event``."""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp

from bdm_db1_tpu_torch.core.config import db1_tiny
from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
from bdm_db1_tpu_torch.train import step as tstep
from bdm_db1_tpu_torch.train.checkpoint import CheckpointManager
from bdm_db1_tpu_torch.train.trainer import Trainer, to_gato_batch
from tests.torch_port_helpers import one_thread

# (optimizer, fused, mu dtype, nu dtype): the chain in f32, the fused
# AdamW, bf16 moments
OPTIMIZERS = [("adamw", False, None, None), ("adamw", True, None, None),
              ("adamw", False, "bfloat16", "bfloat16")]


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _cfg(opt=OPTIMIZERS[0], **train):
    """db1_tiny in f32 with its dropout on (drop, embd_pdrop 0.1)."""
    cfg = db1_tiny(dtype="float32")
    name, fused, mu, nu = opt
    cfg.train = dataclasses.replace(
        cfg.train, log_interval=1, eval_interval=1 << 30,
        optimizer=dataclasses.replace(
            cfg.train.optimizer, optimizer=name, fused=fused,
            adam_mu_dtype=mu, adam_nu_dtype=nu, lr=1e-3), **train)
    return cfg


def _state(cfg, seed):
    model = TransformerXL(cfg.model, cfg.vocab, device="cpu",
                          generator=torch.Generator().manual_seed(seed))
    return tstep.init_train_state(model, cfg.train.optimizer,
                                  cfg.train.train_iters)


def _raw_batch(cfg, seed=0):
    """One loader batch [accum 1, micro 2, L] of a tiny vocab."""
    rng = np.random.RandomState(seed)
    L = cfg.data.seq_length
    shape = (1, 2, L)
    return {"rl": {
        "tokens": rng.randint(0, 321, shape).astype(np.int32),
        "position_id": rng.randint(0, 60, shape).astype(np.int32),
        "loss_mask": (rng.rand(*shape) < 0.5).astype(np.float32),
        "label": rng.randint(0, 321, shape).astype(np.int32)}}


class FixedLoader:
    """The same batch every time; ``crash_after`` batches, then raises."""

    def __init__(self, raw, crash_after=None):
        self.raw, self.crash_after, self.n = raw, crash_after, 0

    def __iter__(self):
        return self

    def __next__(self):
        self.n += 1
        if self.crash_after is not None and self.n > self.crash_after:
            raise RuntimeError("boom")
        return self.raw


def _recording_step(model, losses):
    step = tstep.make_train_step(model)

    def fn(state, batch, gen):
        state, met = step(state, batch, gen)
        losses.append(met["loss"].clone())
        return state, met

    return fn


def _leaves(state):
    """Every tensor of a train state by name, with the step and the
    generator's state."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    opt = state.optimizer.state_dict()
    out["optimizer.count"] = opt["count"]
    for key in ("mu", "nu"):
        out.update({f"{key}.{k}": v for k, v in opt.get(key, {}).items()})
    out["step"] = torch.tensor(state.step)
    out["generator"] = state.generator.get_state()
    return out


def _assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("opt", OPTIMIZERS, ids=["chain", "fused", "bf16"])
def test_round_trip_restores_the_whole_state(opt, tmp_path):
    cfg = _cfg(opt)
    state = _state(cfg, seed=0)
    state.generator = torch.Generator().manual_seed(7)
    step = tstep.make_train_step(state.model)
    batch = to_gato_batch(_raw_batch(cfg), "cpu")
    for _ in range(2):
        state, _ = step(state, batch, state.generator)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.latest_step() is None
    assert mgr.restore(state) == (None, None)
    mgr.save(2, state, client_state={"iteration": 2, "note": "test"})
    mgr.wait()
    assert mgr.latest_step() == 2
    saved = {k: v.clone() for k, v in _leaves(state).items()}

    fresh = _state(cfg, seed=1)               # other weights, no moments
    fresh.generator = torch.Generator().manual_seed(99)
    restored, client = mgr.restore(fresh)
    mgr.close()
    assert restored is fresh and client == {"iteration": 2, "note": "test"}
    assert fresh.step == 2 and fresh.optimizer.count == 2
    _assert_bitwise(_leaves(fresh), saved)
    mu_dt = getattr(torch, opt[2]) if opt[2] else torch.float32
    assert all(t.dtype == mu_dt
               for t in fresh.optimizer.state_dict()["mu"].values())


def test_pruning_keeps_the_newest_three(tmp_path):
    cfg = _cfg()
    state = _state(cfg, seed=0)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    for s in (1, 2, 3, 4):
        mgr.save(s, state, client_state={"iteration": s})
    assert mgr.all_steps() == [2, 3, 4] and mgr.latest_step() == 4
    assert sorted(os.listdir(mgr.directory)) == ["2", "3", "4"]
    mgr.save(4, state, client_state={"iteration": 4, "again": True})
    assert mgr.all_steps() == [2, 3, 4]
    assert mgr.restore(state, step=4)[1] == {"iteration": 4, "again": True}
    assert mgr.restore(state, step=2)[1] == {"iteration": 2}
    # saved without a generator: a restore keeps the state's own
    state.generator = torch.Generator().manual_seed(11)
    before = state.generator.get_state()
    assert mgr.restore(state)[0] is state
    assert torch.equal(state.generator.get_state(), before)


def test_fresh_moments_do_not_change_a_run():
    """Creating the moments before the first step (as a load does) gives
    the same numbers as creating them at the first step."""
    cfg = _cfg()
    batch = to_gato_batch(_raw_batch(cfg), "cpu")
    params = []
    for early in (False, True):
        state = _state(cfg, seed=0)
        if early:
            state.optimizer.init_moments()
        step = tstep.make_train_step(state.model)
        gen = torch.Generator().manual_seed(3)
        for _ in range(2):
            state, _ = step(state, batch, gen)
        params.append(state.model.state_dict())
    _assert_bitwise(*params)


@pytest.mark.parametrize("opt", OPTIMIZERS[:2], ids=["chain", "fused"])
def test_resumed_trainer_is_bitwise_equal(opt, tmp_path):
    """3 iterations in one run against 2, a save, and a fresh model and
    optimizer resumed to 3, on a fixed batch with dropout on: the
    parameters, the moments and every loss bitwise equal. Every optimizer
    is built for the whole run's 3 iterations (the schedules depend on
    it); the first part's Trainer stops at 2."""
    raw = _raw_batch(_cfg(opt))
    whole, losses_a = _state(_cfg(opt, train_iters=3), seed=0), []
    whole = Trainer(_cfg(opt, train_iters=3), whole.model,
                    _recording_step(whole.model, losses_a), whole,
                    FixedLoader(raw))
    whole.train()

    run = str(tmp_path / "run")
    first, losses_b = _state(_cfg(opt, train_iters=3), seed=0), []
    Trainer(_cfg(opt, train_iters=2, save_dir=run), first.model,
            _recording_step(first.model, losses_b), first,
            FixedLoader(raw)).train()
    second = _state(_cfg(opt, train_iters=3), seed=5)
    trainer = Trainer(_cfg(opt, train_iters=3, save_dir=run), second.model,
                      _recording_step(second.model, losses_b), second,
                      FixedLoader(raw))
    trainer.train()
    assert trainer.state.step == 3 and len(losses_b) == 3
    assert all(torch.equal(a, b) for a, b in zip(losses_a, losses_b))
    _assert_bitwise(_leaves(trainer.state), _leaves(whole.state))
    assert trainer.ckpt.all_steps() == [2, 3]


def test_emergency_checkpoint_on_crash(tmp_path):
    cfg = _cfg(train_iters=100, save_dir=str(tmp_path / "run"))
    state = _state(cfg, seed=0)
    trainer = Trainer(cfg, state.model, tstep.make_train_step(state.model),
                      state, FixedLoader(_raw_batch(cfg), crash_after=3))
    with pytest.raises(RuntimeError, match="boom"):
        trainer.train()
    # the emergency checkpoint landed at the crash step
    assert trainer.ckpt.latest_step() == 3
    fresh = _state(cfg, seed=1)
    fresh.generator = torch.Generator()
    restored, client = trainer.ckpt.restore(fresh)
    assert client == {"iteration": 3, "emergency": True}
    assert restored.step == 3
    _assert_bitwise(_leaves(restored), _leaves(trainer.state))


def test_trainer_checkpoints_like_jax(tmp_path):
    """save_interval 2, train_iters 3: both Trainers leave steps {2, 3}, the
    same client iteration and the same train/ keys in metrics.jsonl."""
    import jax
    import jax.numpy as jnp

    from bdm_db1_tpu.core.config import db1_tiny as jdb1_tiny
    from bdm_db1_tpu.data.input_specs import RLTaskBatch
    from bdm_db1_tpu.models.transformer_xl import TransformerXL as JTXL
    from bdm_db1_tpu.train import step as jstep
    from bdm_db1_tpu.train.trainer import Trainer as JTrainer

    raw = _raw_batch(_cfg())
    dirs = {}
    jcfg = jdb1_tiny()
    jcfg.model.dtype = "float32"
    jcfg.train.train_iters, jcfg.train.save_interval = 3, 2
    jcfg.train.log_interval = 1
    jcfg.train.save_dir = dirs["jax"] = str(tmp_path / "jax")
    jmodel = JTXL(jcfg.model, jcfg.vocab, jcfg.vision)
    tx = jstep.make_optimizer(jcfg.train.optimizer, 3)
    jbatch = {"rl": RLTaskBatch(**{k: jnp.asarray(v)
                                  for k, v in raw["rl"].items()})}
    jstate = jstep.init_train_state(jmodel, tx, jax.random.PRNGKey(0),
                                    jbatch)
    jt = JTrainer(jcfg, jmodel, jax.jit(jstep.make_train_step(jmodel, tx)),
                  jstate, FixedLoader(raw))
    jt.train()
    _, jclient = jt.ckpt.restore(jt.state)
    jt.ckpt.close()

    cfg = _cfg(train_iters=3, save_interval=2,
               save_dir=str(tmp_path / "port"))
    dirs["port"] = cfg.train.save_dir
    state = _state(cfg, seed=0)
    pt = Trainer(cfg, state.model, tstep.make_train_step(state.model), state,
                 FixedLoader(raw))
    pt.train()
    _, pclient = pt.ckpt.restore(state)

    steps = {k: sorted(int(d) for d in os.listdir(v) if d.isdigit())
             for k, v in dirs.items()}
    assert steps == {"jax": [2, 3], "port": [2, 3]}
    assert pclient["iteration"] == jclient["iteration"] == 3

    def keys(d):
        recs = [json.loads(line) for line in
                open(os.path.join(d, "metrics.jsonl")).read().splitlines()]
        return [sorted(k for k in r if k.startswith("train/")) for r in recs]

    assert keys(dirs["port"]) == keys(dirs["jax"])
    assert len(keys(dirs["port"])) == 3


def _held_writes(monkeypatch, fail=None):
    """Patch dcp's file writer: each write waits for the returned event,
    then raises ``fail`` when given."""
    go = threading.Event()
    real = dcp.FileSystemWriter.write_data

    def write_data(self, plan, planner):
        assert go.wait(60)
        if fail is not None:
            raise fail
        return real(self, plan, planner)

    monkeypatch.setattr(dcp.FileSystemWriter, "write_data", write_data)
    return go


def _stepped_state(cfg, steps=1):
    """A state with its moments and generator moved by ``steps`` steps, its
    step function and batch."""
    state = _state(cfg, seed=0)
    state.generator = torch.Generator().manual_seed(7)
    step = tstep.make_train_step(state.model)
    batch = to_gato_batch(_raw_batch(cfg), "cpu")
    for _ in range(steps):
        state, _ = step(state, batch, state.generator)
    return state, step, batch


def test_async_save_writes_the_state_of_the_call(monkeypatch, tmp_path):
    """Two train steps while the write is held change every parameter,
    moment and the generator in place; the checkpoint holds the state at
    the ``save`` call, bit for bit."""
    cfg = _cfg()
    state, step, batch = _stepped_state(cfg)
    saved = {k: v.clone() for k, v in _leaves(state).items()}
    go = _held_writes(monkeypatch)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state, client_state={"iteration": 1})
    for _ in range(2):
        state, _ = step(state, batch, state.generator)
    moved = _leaves(state)
    changed = {k for k in saved if not torch.equal(moved[k], saved[k])}
    assert {"generator", "step", "optimizer.count",
            "model.word_embedding.weight"} <= changed
    assert len(changed) > len(saved) // 2
    go.set()
    mgr.wait()
    fresh = _state(cfg, seed=1)
    fresh.generator = torch.Generator().manual_seed(99)
    restored, client = mgr.restore(fresh)
    mgr.close()
    assert restored is fresh and client == {"iteration": 1}
    _assert_bitwise(_leaves(fresh), saved)
    assert mgr.last_stage["bytes"] > 0


def test_unfinished_save_is_invisible(monkeypatch, tmp_path):
    """While the write is held, the step is only a temporary directory: a
    second manager on the directory sees no step; the saving manager's
    ``latest_step`` waits for the write and returns the step."""
    cfg = _cfg()
    state, _, _ = _stepped_state(cfg)
    go = _held_writes(monkeypatch)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    other = CheckpointManager(mgr.directory)
    mgr.save(3, state, client_state={"iteration": 3})
    assert other.latest_step() is None and other.all_steps() == []
    assert not os.path.exists(mgr.step_dir(3))
    assert other.restore(state) == (None, None)
    threading.Timer(0.2, go.set).start()
    assert mgr.latest_step() == 3 and go.is_set()
    assert other.all_steps() == [3]
    assert other.restore(state)[1] == {"iteration": 3}


def test_failed_async_save_raises_at_wait(monkeypatch, tmp_path):
    """A write that raises: ``wait`` raises its error once, no step
    directory (nor its temporary one) is left, and a later save works."""
    cfg = _cfg()
    state, _, _ = _stepped_state(cfg)
    go = _held_writes(monkeypatch, fail=OSError("no space left on device"))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(2, state)
    go.set()
    with pytest.raises(OSError, match="no space left on device"):
        mgr.wait()
    mgr.wait()
    assert mgr.all_steps() == [] and os.listdir(mgr.directory) == []
    monkeypatch.undo()
    mgr.save(2, state, client_state={"iteration": 2})
    mgr.wait()
    assert mgr.all_steps() == [2]
    assert mgr.restore(state)[1] == {"iteration": 2}
