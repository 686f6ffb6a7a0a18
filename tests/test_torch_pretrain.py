"""The port's NLP path and pretraining driver against the JAX package's, on
the CPU: text groups through the model (``[rl rows || nlp rows]``), the
mixed ``{"rl", "nlp"}`` train step at db1_tiny (f32 within the train-step
bars; bf16 in both packages, the gradient cosine), ``pretrain.main`` end
to end (checkpoint, metric keys, eval hook) and what it refuses,
behaviour cloning, and the tokenizer suite the RL driver shares."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdm_db1_tpu.data.input_specs import NLPTaskBatch as JNLP
from bdm_db1_tpu.data.input_specs import RLTaskBatch as JRL
from bdm_db1_tpu.train import step as jstep
from bdm_db1_tpu_torch.core import config as tcfg
from bdm_db1_tpu_torch.data.input_specs import NLPTaskBatch, RLTaskBatch
from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL as PortTXL
from bdm_db1_tpu_torch.train import pretrain as tpt
from bdm_db1_tpu_torch.train import step as tstep
from bdm_db1_tpu_torch.train.convert import load_jax_params, state_dict_from_jax
from bdm_db1_tpu_torch.train.trainer import to_gato_batch
from tests.torch_port_helpers import jax_tiny, one_thread, to_numpy

# the bars of tests/test_torch_train_step.py (f32 on both sides): losses
# are sums of the same terms in another order; each gradient leaf within
# GRAD_RTOL of its largest value
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# bf16 activations in both packages: the whole-model gradient cosine the
# port predicted for itself (ROADMAP queue 3, "bf16 drift")
BF16_GRAD_COS_MIN = 0.999
SEQ = 64
_NO_DROP = dict(drop=0.0, embd_pdrop=0.0, dropattn=0.0)


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _mixed_numpy(accum=2, n_rl=1, n_nlp=2, seed=0):
    """{"rl": {...}, "nlp": {...}} with [accum, rows, SEQ] fields; text ids
    below db1_tiny's text vocab (256), every text token scored."""
    rng = np.random.RandomState(seed)
    rl = (accum, n_rl, SEQ)
    nlp = (accum, n_nlp, SEQ)
    return {"rl": {"tokens": rng.randint(0, 321, rl),
                   "position_id": rng.randint(0, 60, rl),
                   "loss_mask": (rng.rand(*rl) < 0.4).astype(np.float32),
                   "label": rng.randint(0, 321, rl)},
            "nlp": {"tokens": rng.randint(0, 256, nlp),
                    "loss_mask": np.ones(nlp, np.float32),
                    "label": rng.randint(0, 256, nlp)}}


def _jax_batch(nb):
    return {"rl": JRL(**{k: jnp.asarray(v) for k, v in nb["rl"].items()}),
            "nlp": JNLP(**{k: jnp.asarray(v) for k, v in nb["nlp"].items()})}


def _port_model(pnp, dtype):
    pcfg = tcfg.db1_tiny(dtype=dtype, **_NO_DROP)
    model = PortTXL(pcfg.model, pcfg.vocab, device="cpu")
    load_jax_params(model, pnp)
    return model


# ---- text groups through the model ------------------------------------------

def test_mixed_forward_logits_equal_jax():
    """Logits of a {"rl", "nlp"} batch: rows in [rl || nlp] order, the text
    rows without the timestep term (f32, the bar of tests/test_parity.py)."""
    cfg, model, params, pnp = jax_tiny(**_NO_DROP)
    nb = _mixed_numpy(accum=1, n_rl=2, n_nlp=3, seed=1)
    micro = {m: {k: v[0] for k, v in f.items()} for m, f in nb.items()}
    want, _ = jax.jit(lambda p, b: model.apply(
        {"params": p}, b, compute_loss=False))(params, _jax_batch(micro))
    port = _port_model(pnp, "float32")
    with torch.no_grad():
        got, _ = port(to_gato_batch(micro, "cpu"), compute_loss=False)
    assert got.shape == (5,) + tuple(want.shape[1:])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4 * float(np.abs(want).max()))


def test_groups_the_port_refuses():
    """to_gato_batch types "nlp", "ic" and "vqa" (host-only fields such as
    ``img_id`` dropped) and raises on an unknown group, as the model does;
    the entry point's default device is the card. Image groups run through
    the model in tests/test_torch_vision.py."""
    from bdm_db1_tpu_torch.data.input_specs import ICTaskBatch, VQATaskBatch

    nb = _mixed_numpy(accum=1)
    micro = {m: {k: v[0] for k, v in f.items()} for m, f in nb.items()}
    typed = to_gato_batch(micro, "cpu")
    assert isinstance(typed["nlp"], NLPTaskBatch)
    assert isinstance(typed["rl"], RLTaskBatch)
    img = {"prompt": np.zeros((1, 2), np.int32),
           "images": np.zeros((1, 32, 32, 3), np.float32),
           "text": np.zeros((1, 58), np.int32), "img_id": np.zeros(1),
           "ques_len": np.full(1, 3), "ques_id": np.zeros(1)}
    ic, vqa = (to_gato_batch({g: img}, "cpu")[g] for g in ("ic", "vqa"))
    assert isinstance(ic, ICTaskBatch) and isinstance(vqa, VQATaskBatch)
    assert int(vqa.ques_len[0]) == 3
    with pytest.raises(ValueError, match="unknown modality"):
        to_gato_batch({"audio": micro["nlp"]}, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            to_gato_batch(micro)
    _, _, _, pnp = jax_tiny()
    model = _port_model(pnp, "float32")
    with pytest.raises(ValueError, match="unknown modality"):
        model.embed_concat(dict(typed, audio=typed["nlp"]),
                           with_targets=False)


# ---- the mixed train step ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_grads(dtype):
    """JAX: (mean loss of the two micro-batches, their averaged gradients
    as numpy), through make_loss_fn as make_train_step takes it."""
    _, model, params, pnp = jax_tiny(attention_impl="xla", dtype=dtype,
                                     **_NO_DROP)
    batch = _jax_batch(_mixed_numpy())
    gfn = jax.jit(jax.value_and_grad(jstep.make_loss_fn(model)))
    rng = jax.random.PRNGKey(0)
    out = [gfn(params, jax.tree.map(lambda x: x[a], batch), rng)
           for a in range(2)]
    loss = float(sum(float(l) for l, _ in out) / 2)
    grads = jax.tree.map(lambda a, b: (a + b) / 2, out[0][1], out[1][1])
    return loss, to_numpy(grads), pnp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixed_batch_step_matches_jax(dtype):
    """db1_tiny, dropout 0, accum 2 over {"rl" 1 row, "nlp" 2 rows} x 64 on
    the rel_attention route: the port's first train step against the JAX
    loss function's. f32: the loss within LOSS_RTOL and each gradient leaf
    within GRAD_RTOL of its largest value (tests/test_torch_train_step.py's
    bars). bf16 in both packages: the whole-model gradient cosine at least
    BF16_GRAD_COS_MIN; the cosine, the largest leaf gap and the loss gap
    are printed."""
    j_loss, j_grads, pnp = _jax_grads(dtype)
    model = _port_model(pnp, dtype)
    batch = to_gato_batch(_mixed_numpy(), "cpu")
    state = tstep.init_train_state(model, tcfg.OptimizerConfig(lr=1e-4), 20)
    # the step's averaged gradients, read as the optimizer takes them
    grads = {}
    named = list(model.named_parameters())
    opt_step = state.optimizer.step

    def reading_step():
        grads.update({n: p.grad.detach().clone() for n, p in named
                      if p.grad is not None})
        return opt_step()

    state.optimizer.step = reading_step
    state, met = tstep.make_train_step(model)(state, batch, torch.Generator())
    # the vision tower takes no part in an {rl, nlp} batch: no gradient
    assert state.step == 1 and grads.keys() == {
        n for n, _ in named if not n.startswith("vision_encoder.")}
    j_sd, _ = state_dict_from_jax(j_grads, tcfg.db1_tiny())
    loss = float(met["loss"])
    if dtype == "float32":
        assert abs(loss - j_loss) <= LOSS_RTOL * abs(j_loss)
        for name, g in grads.items():
            ref = j_sd[name].numpy()
            np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                       atol=GRAD_RTOL * np.abs(ref).max(),
                                       err_msg=name)
        return
    a = torch.cat([g.flatten().double() for g in grads.values()])
    b = torch.cat([j_sd[n].flatten().double() for n in grads])
    cos = float(a @ b / (a.norm() * b.norm()))
    gap = max(float((grads[n].double() - j_sd[n].double()).abs().max()
                    / j_sd[n].double().abs().max()) for n in grads)
    print(f"bf16 port vs JAX at db1_tiny: gradient cosine {cos:.6f}, "
          f"largest leaf gap {gap:.3e} of the leaf's max, loss "
          f"{loss:.6f} vs {j_loss:.6f}")
    assert cos >= BF16_GRAD_COS_MIN, (cos, gap)


def test_text_only_step_matches_jax():
    """A batch of text rows alone (a text, captioning or VQA mixture has
    no RL rows): the port's step leaves the RL timestep embedding and the
    vision tower without a gradient, where JAX's are zero, and its loss and
    every other gradient are JAX's within the f32 bars."""
    _, model, params, pnp = jax_tiny(attention_impl="xla", **_NO_DROP)
    nb = {"nlp": _mixed_numpy(accum=1)["nlp"]}
    micro = {"nlp": JNLP(**{k: jnp.asarray(v[0])
                            for k, v in nb["nlp"].items()})}
    j_loss, j_grads = jax.jit(jax.value_and_grad(jstep.make_loss_fn(model)))(
        params, micro, jax.random.PRNGKey(0))
    j_sd, _ = state_dict_from_jax(to_numpy(j_grads), tcfg.db1_tiny())
    port = _port_model(pnp, "float32")
    state = tstep.init_train_state(port, tcfg.OptimizerConfig(lr=1e-4), 20)
    grads = {}
    named = list(port.named_parameters())
    opt_step = state.optimizer.step

    def reading_step():
        grads.update({n: p.grad.detach().clone() for n, p in named
                      if p.grad is not None})
        return opt_step()

    state.optimizer.step = reading_step
    _, met = tstep.make_train_step(port)(state, to_gato_batch(nb, "cpu"),
                                         torch.Generator())
    assert grads.keys() == {
        n for n, _ in named if not n.startswith(
            ("vision_encoder.", "rl_local_timestep_embedding."))}
    assert not j_sd["rl_local_timestep_embedding.weight"].any()
    assert abs(float(met["loss"]) - float(j_loss)) <= LOSS_RTOL * abs(
        float(j_loss))
    for name, g in grads.items():
        ref = j_sd[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=GRAD_RTOL * np.abs(ref).max(),
                                   err_msg=name)


# ---- pretrain.main -----------------------------------------------------------

ENV = "fake-continuous-v0"


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A byte-level corpus written by the port's builder and the RL cache of
    the registry's fake-continuous-v0 geometry (obs 5, act 2)."""
    from bdm_db1_tpu_torch.data.indexed_dataset import make_builder
    from bdm_db1_tpu_torch.data.rl_dataset import TrajectoryStore
    from bdm_db1_tpu_torch.eval.envs import FakeContinuousEnv

    tmp = tmp_path_factory.mktemp("pretrain")
    rng = np.random.RandomState(0)
    b = make_builder(str(tmp / "corpus"), vocab_size=256)
    for _ in range(30):
        b.add_document(rng.randint(1, 200, size=60))
    b.finalize()
    TrajectoryStore.from_flat_dataset(
        FakeContinuousEnv(episode_len=8).make_dataset(5)).save_cache(
        str(tmp / "rl"), ENV)
    return tmp


def _main_cfg(ws, run: str):
    """tests/test_drivers.py's test_pretrain_main at db1_tiny in f32 on one
    process (model_parallel 1), with the eval hook at the last step."""
    cfg = tcfg.db1_tiny(dtype="float32")
    cfg.data.rl_dataset_cache_dir = str(ws / "rl")
    cfg.data.seq_length = cfg.model.n_position
    cfg.data.num_workers = 1
    cfg.data.data_path = ("0.5", str(ws / "corpus"), "nlp", "0.5", ENV, "rl")
    t = cfg.train
    t.train_iters, t.global_batch_size, t.micro_batch_size = 3, 16, 8
    t.log_interval, t.eval_interval, t.eval_iters = 1, 3, 1
    t.save_interval, t.save_dir = 3, str(ws / run)
    cfg.eval.env_names = (ENV,)
    cfg.eval.num_trials, cfg.eval.max_step_size = 1, 2
    return cfg


def _jax_train_keys():
    """The train keys the JAX Trainer logs for pretrain.main's step: loss and
    tokens_per_sec, plus grad_norm when the step's metrics carry one
    (bdm_db1_tpu/train/trainer.py:142-145); the step's metrics read from
    jax.eval_shape of make_train_step as pretrain's sharded step builds it
    (default with_grad_norm)."""
    _, model, params, _ = jax_tiny()
    tx = jstep.make_optimizer(tcfg.OptimizerConfig(), 3)
    state = jstep.TrainState(step=jnp.zeros([], jnp.int32), params=params,
                             opt_state=tx.init(params))
    nb = _mixed_numpy()
    _, metrics = jax.eval_shape(jstep.make_train_step(model, tx), state,
                                _jax_batch(nb), jax.random.PRNGKey(0))
    return {"train/loss", "train/tokens_per_sec"} | (
        {"train/grad_norm"} if "grad_norm" in metrics else set())


def test_pretrain_main_on_cpu(workspace):
    """3 iterations of 16 / 8 on a 0.5 nlp / 0.5 rl mixture: every batch
    carries both groups [2, 4, 64]; the step-3 checkpoint with its client
    state; metrics.jsonl with the JAX Trainer's train keys each step and
    the eval hook's valid loss and RL rollout at step 3."""
    from bdm_db1_tpu_torch.train import trainer as ttrainer

    cfg = _main_cfg(workspace, "run")
    seen = []
    orig = ttrainer.to_gato_batch

    def recording(raw, device="cuda"):
        seen.append({m: f["tokens"].shape for m, f in raw.items()})
        return orig(raw, device)

    ttrainer.to_gato_batch = recording
    try:
        tpt.main(cfg, device="cpu")
    finally:
        ttrainer.to_gato_batch = orig
    assert seen[:3] == [{"rl": (2, 4, 64), "nlp": (2, 4, 64)}] * 3
    run = workspace / "run"
    assert (run / "3" / "client.json").read_text() == '{"iteration": 3}'
    recs = [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if "train/loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3]
    keys = _jax_train_keys()
    for r in train:
        assert set(r) - {"step", "time"} == keys
        assert np.isfinite(r["train/loss"])
    valid = [r for r in recs if "valid/loss" in r]
    assert len(valid) == 1 and valid[0]["step"] == 3
    assert np.isfinite(valid[0]["valid/loss"])
    assert valid[0][f"valid/length/{ENV}"] == 2.0
    assert np.isfinite(valid[0][f"valid/return/{ENV}"])


@pytest.mark.parametrize("change,error,match", [
    # a model_parallel that does not divide db1_tiny's 4 heads
    (("mesh", "model_parallel", 3), ValueError, "n_head"),
    # a pipeline_parallel that does not divide db1_tiny's 2 layers
    (("mesh", "pipeline_parallel", 3), ValueError, "n_layer"),
    # a multi-process run without the launcher's rendezvous address, and
    # a data-parallel size that is not the world's, raise instead of
    # training in one process
    (("mesh", "multihost", True), ValueError, "MASTER_ADDR"),
    (("mesh", "data_parallel", 2), ValueError, "data_parallel is 2"),
    # a captioning or VQA mixture at the default eval.ic_vqa_num_samples
    # runs: tests/test_torch_ic_vqa.py::test_in_training_caption_metrics_
    # match_jax holds its metrics to the JAX package's
])
def test_pretrain_main_refuses(workspace, change, error, match, monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    cfg = _main_cfg(workspace, "refused")
    group, field, value = change
    setattr(getattr(cfg, group), field, value)
    with pytest.raises(error, match=match):
        tpt.main(cfg, device="cpu")
    assert not (workspace / "refused").exists()


def test_pretrain_main_defaults_to_the_card(workspace):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpt.main(_main_cfg(workspace, "nocard"))


def test_tokenizer_suite_is_shared_with_the_rl_driver():
    """evaluate_rl takes pretrain's suite, as the JAX driver does, and the
    suite is the JAX package's: byte text tokenizer over the text vocab,
    the vision patch size."""
    from bdm_db1_tpu.core.config import db1_tiny as jtiny
    from bdm_db1_tpu.train.pretrain import build_tokenizer_suite as jsuite
    from bdm_db1_tpu_torch.eval import evaluate_rl

    assert evaluate_rl.build_tokenizer_suite is tpt.build_tokenizer_suite
    j, t = jsuite(jtiny()), tpt.build_tokenizer_suite(tcfg.db1_tiny())
    assert type(t.text_tokenizer).__name__ == type(j.text_tokenizer).__name__
    assert (t.text_tokenizer.vocab_size, t.text_tokenizer.eos_token_id) == (
        j.text_tokenizer.vocab_size, j.text_tokenizer.eos_token_id)
    assert t.vision_patch_size == j.vision_patch_size
    assert t.layout.total_vocab_size == j.layout.total_vocab_size


# ---- behaviour cloning -------------------------------------------------------

def test_behavior_clone_lowers_the_loss():
    """tests/test_bc_integration.py's set-up at 30 steps: the masked CE on
    the cloned batches falls by at least 20%."""
    from bdm_db1_tpu_torch.data.rl_dataset import (
        RLFullDataset, RLTokenizerSuite, TrajectoryStore,
    )
    from bdm_db1_tpu_torch.eval.envs import FakeContinuousEnv
    from bdm_db1_tpu_torch.tokenizers.scalar import ScalarTokenizer
    from bdm_db1_tpu_torch.train.bc import behavior_clone, pack_bc_batch
    from bdm_db1_tpu_torch.train.trainer import evaluate_loss

    cfg = tcfg.db1_tiny(n_embed=128, n_layer=2, n_head=4, n_inner=512,
                        mem_len=32, dtype="float32", drop=0.0,
                        embd_pdrop=0.0)
    suite = RLTokenizerSuite(cfg.vocab.layout(),
                             ScalarTokenizer(cfg.vocab.num_continuous_bin))
    store = TrajectoryStore.from_flat_dataset(FakeContinuousEnv(
        obs_dim=4, act_dim=2, episode_len=20, seed=7).make_dataset(10))
    ds = RLFullDataset("fake", store, suite, seq_length=cfg.model.n_position,
                       use_prompt=False, seed=0)
    model = PortTXL(cfg.model, cfg.vocab, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    ids = np.random.RandomState(0).choice(len(ds), size=16, replace=False)
    batches = pack_bc_batch(ds, ids, 8)
    before = evaluate_loss(model, batches, device="cpu")
    out = behavior_clone(cfg, model, ds, steps=30, micro=8, lr=3e-3,
                         seed=0, distinct_batches=2)
    assert out is model
    after = evaluate_loss(model, batches, device="cpu")
    assert after < 0.8 * before, (before, after)
    # at db1_1p2b's depth behaviour cloning defaults to remat (the JAX
    # default), runs, and leaves the model's own remat flag as it was
    out = behavior_clone(tcfg.db1_1p2b(), model, ds, steps=2, micro=8,
                         distinct_batches=1)
    assert out is model and not model.cfg.remat
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
