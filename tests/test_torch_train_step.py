"""The port's training path against the JAX package's, on the CPU: the
schedules, both dropout implementations, the fused-CE backward, the weight
decay mask, ``make_train_step`` (losses, gradients and parameters at
db1_tiny, through the K3-K5 route and the ``rel_attention`` route, for the
chain, the fused AdamW and a bf16 second moment), the samplers and the
loader, and the ``Trainer`` loop."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdm_db1_tpu.core.config import OptimizerConfig as JOpt
from bdm_db1_tpu.data import samplers as js
from bdm_db1_tpu.data.input_specs import RLTaskBatch as JBatch
from bdm_db1_tpu.ops import fused_ce as jf
from bdm_db1_tpu.train import schedule as jsch
from bdm_db1_tpu.train import step as jstep
from bdm_db1_tpu_torch.core import config as tcfg
from bdm_db1_tpu_torch.data import samplers as ts
from bdm_db1_tpu_torch.data.input_specs import RLTaskBatch as TBatch
from bdm_db1_tpu_torch.models.transformer_xl import use_rel_kernel
from bdm_db1_tpu_torch.ops import fast_dropout as fd
from bdm_db1_tpu_torch.ops import fused_ce as tf
from bdm_db1_tpu_torch.train import schedule as tsch
from bdm_db1_tpu_torch.train import step as tstep
from bdm_db1_tpu_torch.train.convert import state_dict_from_jax
from bdm_db1_tpu_torch.train.trainer import Trainer
from tests.torch_port_helpers import jax_tiny, one_thread, port_model

# schedules: both in f32, numpy's cos against XLA's
SCHED_RTOL = 1e-6
# fused CE: f32 sums of the same terms in another order
CE_TOL = 1e-6
# the train step, f32 on both sides:
# losses, sums of the same terms in another order
LOSS_RTOL = 1e-5
# gradients at the first step, each leaf within GRAD_RTOL of its largest
# value (the trunk's f32 rounding, carried through two layers and the CE)
GRAD_RTOL = 1e-4
# Parameters after 3 steps. Adam divides each gradient by its running RMS,
# so an element whose gradient is near zero moves by up to lr a step in
# either package whatever its f32 rounding: a single element may differ by
# one update, 2 lr over 3 steps (lr <= 1e-4 here). The update as a whole
# must agree: ||dp_port - dp_jax|| at most UPDATE_RTOL of ||dp_jax|| per
# leaf, while a wrong moment, bias correction, clip, decay or schedule moves
# every element of a leaf's update.
PARAM_ATOL = 2 * 1e-4
UPDATE_RTOL = 2e-3


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


# ---- schedules -------------------------------------------------------------

@pytest.mark.parametrize("style,warmup,frac,decay_iters", [
    ("constant", 5, None, None), ("linear", 0, 0.1, None),
    ("cosine", 3, None, 40), ("cosine", 0, None, None),
    ("inverse-square-root", 6, None, None)])
def test_lr_schedule_matches_jax(style, warmup, frac, decay_iters):
    kw = dict(lr=3e-4, min_lr=2e-5, lr_decay_style=style,
              lr_warmup_iters=warmup, lr_warmup_fraction=frac,
              lr_decay_iters=decay_iters)
    j = jsch.lr_schedule(JOpt(**kw), 50)
    t = tsch.lr_schedule(tcfg.OptimizerConfig(**kw), 50)
    steps = np.arange(0, 60)
    np.testing.assert_allclose([t(int(s)) for s in steps],
                               np.asarray([j(s) for s in steps]),
                               rtol=SCHED_RTOL)


@pytest.mark.parametrize("style", ["constant", "linear", "cosine"])
def test_wd_schedule_matches_jax(style):
    kw = dict(start_weight_decay=0.02, end_weight_decay=0.1,
              weight_decay_incr_style=style)
    j = jsch.wd_schedule(JOpt(**kw), 30)
    t = tsch.wd_schedule(tcfg.OptimizerConfig(**kw), 30)
    steps = np.arange(0, 40)
    np.testing.assert_allclose([t(int(s)) for s in steps],
                               np.asarray([j(s) for s in steps]),
                               rtol=SCHED_RTOL)


# ---- dropout ---------------------------------------------------------------

@pytest.mark.parametrize("impl,keep,scale", [
    ("flax", 0.9, 1 / 0.9), ("u8", 230 / 256, 256 / 230)])
def test_dropout_keep_rate_scale_and_mean(impl, keep, scale):
    """Rate 0.1: the keep share and the survivors' scale (u8 quantizes the
    keep probability to 230/256 and rescales by it), and the mean stays
    that of the input. n = 2^20 draws: the keep share is within 5 standard
    deviations (~0.0015) of its probability."""
    x = torch.ones(1 << 20)
    out = fd.dropout(x, 0.1, torch.Generator().manual_seed(0), impl)
    kept = out != 0
    sd = (keep * (1 - keep) / x.numel()) ** 0.5
    assert abs(float(kept.float().mean()) - keep) < 5 * sd
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], scale))
    assert abs(float(out.mean()) - 1.0) < 5 * sd * scale


@pytest.mark.parametrize("impl", ["flax", "u8"])
def test_dropout_masks_follow_the_generator(impl):
    x = torch.randn(64, 33)
    a = fd.dropout(x, 0.3, torch.Generator().manual_seed(5), impl)
    b = fd.dropout(x, 0.3, torch.Generator().manual_seed(5), impl)
    c = fd.dropout(x, 0.3, torch.Generator().manual_seed(6), impl)
    assert torch.equal(a, b) and not torch.equal(a, c)
    gen = torch.Generator().manual_seed(1)
    before = gen.get_state()
    assert fd.dropout(x, 0.0, gen, impl) is x          # rate 0 draws nothing
    assert torch.equal(gen.get_state(), before)
    with pytest.raises(ValueError, match="Generator"):
        fd.dropout(x, 0.3, None, impl)


def test_dropout_u8_edge_cases_follow_jax():
    """keep_q = round((1 - rate) * 256) as fast_dropout.dropout_u8: 256 is
    the identity, 0 gives zeros."""
    from bdm_db1_tpu.ops.fast_dropout import dropout_u8 as jdrop

    x = np.ones((4, 8), np.float32)
    gen = torch.Generator().manual_seed(0)
    for rate in (0.001, 0.999, 1.0):
        j = np.asarray(jdrop(jnp.asarray(x), rate, jax.random.PRNGKey(0)))
        t = fd.dropout_u8(torch.from_numpy(x), rate, gen).numpy()
        np.testing.assert_array_equal(t, j)


def test_attention_dropout_takes_rel_attention():
    cfg = tcfg.db1_tiny().model
    cfg.attention_impl = "pallas"
    assert use_rel_kernel(cfg, 1024, 1024, "cpu")
    assert not use_rel_kernel(cfg, 1024, 1024, "cpu", use_dropatt=True)


def test_training_forward_draws_from_the_generator():
    """deterministic=False: the same seed gives the same loss, another seed
    another one (dropout at every site, attention dropout included); no
    generator raises."""
    _, _, _, pnp = jax_tiny()
    model = port_model(pnp, dropattn=0.1)
    batch = _port_batch(_numpy_batch(1, 2, 64, seed=3))
    mb = tstep.micro_batch(batch, 0)

    @torch.no_grad()
    def loss(seed):
        return float(model(mb, deterministic=False, loss_only=True,
                           generator=torch.Generator().manual_seed(seed))[1])

    assert loss(0) == loss(0) != loss(1)
    with pytest.raises(ValueError, match="Generator"):
        model(mb, deterministic=False, loss_only=True)


# ---- fused CE backward -----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ce_backward_matches_jax(dtype):
    """dh and dW of the blockwise CE against ``jax.grad`` of
    ``masked_ce_tied``, the custom VJP under ``masked_cross_entropy_fused``
    (V = 384 in 3 chunks of 128, the tail past 300 out of the softmax). bf16 h: both round dl to bf16 before the products,
    so a few bf16 ulps of the largest gradient."""
    rng = np.random.RandomState(0)
    h = rng.randn(2, 24, 32).astype(np.float32)
    emb = (rng.randn(384, 32) * 0.3).astype(np.float32)
    lab = rng.randint(0, 300, (2, 24))
    mask = (rng.rand(2, 24) < 0.5).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax.grad(lambda a, w: jf.masked_ce_tied(
        a, w, jnp.asarray(lab), jnp.asarray(mask), 300, 128),
        argnums=(0, 1))(jnp.asarray(h).astype(jd), jnp.asarray(emb))
    th = torch.from_numpy(h).to(td).requires_grad_(True)
    te = torch.from_numpy(emb).requires_grad_(True)
    loss = tf.masked_ce_tied(th, te, torch.from_numpy(lab),
                             torch.from_numpy(mask), 300, 128)
    got = torch.autograd.grad(loss, (th, te))
    tol = CE_TOL if dtype == "float32" else 2e-2
    for a, b in zip(got, ref):
        b = np.asarray(b.astype(jnp.float32))
        assert a.dtype == (td if a.shape == th.shape else torch.float32)
        np.testing.assert_allclose(a.float().numpy(), b, rtol=0,
                                   atol=tol * np.abs(b).max())


# ---- the decay mask --------------------------------------------------------

def test_decay_mask_decays_what_jax_decays():
    """The JAX mask (rank >= 2 of the scan-stacked leaves) carried onto the
    port's names through the weight bridge: every parameter of the trunk
    is decayed, as in the JAX package, biases and LayerNorms included. The
    tree has no vision subtree (an RL-only init); the vision tower's names
    are held to JAX's mask in tests/test_torch_vision.py."""
    cfg, _, params, pnp = jax_tiny()
    jmask = jax.tree.map(
        lambda p: np.full(p.shape, float(np.ndim(p) >= 2), np.float32), pnp)
    sd, _ = state_dict_from_jax(jmask, tcfg.db1_tiny())
    model = port_model(pnp)
    mask = tstep.decay_mask(model)
    trunk = {n: d for n, d in mask.items()
             if not n.startswith("vision_encoder.")}
    assert len(mask) - len(trunk) == 14 and set(trunk) <= set(sd)
    assert trunk and all(trunk.values())
    for name, decayed in trunk.items():
        assert bool(sd[name].all()) == decayed, name


# ---- the train step --------------------------------------------------------

def _numpy_batch(accum, micro, seq, seed):
    rng = np.random.RandomState(seed)
    shape = (accum, micro, seq)
    return {"tokens": rng.randint(0, 321, shape),      # db1_tiny's vocab
            "position_id": rng.randint(0, 60, shape),
            "loss_mask": (rng.rand(*shape) < 0.4).astype(np.float32),
            "label": rng.randint(0, 321, shape)}


def _port_batch(nb):
    return {"rl": TBatch(**{k: torch.from_numpy(v) for k, v in nb.items()})}


def _jax_batch(nb):
    return {"rl": JBatch(**{k: jnp.asarray(v) for k, v in nb.items()})}


_NO_DROP = dict(drop=0.0, embd_pdrop=0.0, dropattn=0.0)


@functools.lru_cache(maxsize=None)
def _jax_run(seq, opt_items, n_steps):
    """JAX: the first step's averaged gradients, then n_steps of the
    jitted train step; (losses, grads as numpy, params as numpy)."""
    cfg, model, _, pnp = jax_tiny(n_position=seq, attention_impl="xla",
                                  **_NO_DROP)
    params = jax.tree.map(jnp.asarray, pnp)
    opt = JOpt(**dict(opt_items))
    tx = jstep.make_optimizer(opt, 20)
    nb = _numpy_batch(2, 1, seq, seed=seq)
    batch = _jax_batch(nb)
    loss_fn = jstep.make_loss_fn(model)
    gfn = jax.jit(jax.grad(loss_fn))
    rng = jax.random.PRNGKey(0)
    grads = [gfn(params, jax.tree.map(lambda x: x[a], batch), rng)
             for a in range(2)]
    grads = jax.tree.map(lambda a, b: (a + b) / 2, *grads)
    state = jstep.TrainState(step=jnp.zeros([], jnp.int32), params=params,
                             opt_state=tx.init(params))
    step = jax.jit(jstep.make_train_step(model, tx))
    losses = []
    for _ in range(n_steps):
        state, met = step(state, batch, rng)
        losses.append(float(met["loss"]))
    return (losses, jax.tree.map(np.asarray, grads),
            jax.tree.map(np.asarray, state.params), nb)


@pytest.mark.parametrize("seq,impl,opt", [
    # the K3-K5 route (plain versions on the CPU) against JAX's "xla" route
    (1024, "pallas", {}),
    # the rel_attention route
    (64, "auto", {"fused": True}),
    (64, "auto", {"adam_nu_dtype": "bfloat16", "adam_mu_dtype": "bfloat16"}),
])
def test_train_step_matches_jax(seq, impl, opt):
    """accum 2 (micro-batches of 1 x seq): per-step losses over 3 steps,
    the first step's gradients leaf by leaf and the parameters after 3
    steps, for the chain, the fused AdamW and bf16 moments."""
    opt = dict(lr=1e-4, lr_warmup_iters=1, **opt)
    j_losses, j_grads, j_params, nb = _jax_run(seq, tuple(sorted(opt.items())),
                                               3)
    _, _, _, pnp = jax_tiny()
    model = port_model(pnp, n_position=seq, attention_impl=impl, **_NO_DROP)
    pcfg = tcfg.db1_tiny()
    assert use_rel_kernel(model.cfg, seq, seq, "cpu") == (seq == 1024)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _port_batch(nb)
    # gradients of the first step, averaged over the two micro-batches
    # the vision tower takes no part in an RL batch (and the JAX tree,
    # initialised on one, has no vision subtree)
    named = [(n, p) for n, p in model.named_parameters()
             if not n.startswith("vision_encoder.")]
    params = [p for _, p in named]
    grads = [torch.zeros_like(p) for p in params]
    for a in range(2):
        _, loss = model(tstep.micro_batch(batch, a), deterministic=False,
                        loss_only=True, generator=torch.Generator())
        for s, g in zip(grads, torch.autograd.grad(loss, params)):
            s.add_(g / 2)
    by_name = dict(zip([n for n, _ in named], grads))
    j_sd, _ = state_dict_from_jax(j_grads, pcfg)
    for name, g in by_name.items():
        ref = j_sd[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=GRAD_RTOL * np.abs(ref).max(),
                                   err_msg=name)
    state = tstep.init_train_state(model, tcfg.OptimizerConfig(**opt), 20)
    step = tstep.make_train_step(model, with_grad_norm=True)
    losses = []
    gen = torch.Generator()
    for i in range(3):
        state, met = step(state, batch, gen)
        losses.append(float(met["loss"]))
        if i == 0:
            # the global norm counts the shared r_w/r_r biases once, as
            # the JAX tree holds them once
            j_norm = float(jnp.sqrt(sum(np.sum(np.square(g)) for g in
                                        jax.tree.leaves(j_grads))))
            assert abs(float(met["grad_norm"]) - j_norm) <= 1e-5 * j_norm
    assert state.step == 3 and state.optimizer.count == 3
    np.testing.assert_allclose(losses, j_losses, rtol=LOSS_RTOL)
    j_after, _ = state_dict_from_jax(j_params, pcfg)
    after = model.state_dict()
    for name, p in after.items():
        if name.startswith("vision_encoder."):
            # no gradient reached it: the optimizer skipped it
            assert torch.equal(p, before[name]), name
            continue
        if name == "pos_emb.inv_freq":
            continue
        dp, dj = p - before[name], j_after[name] - before[name]
        assert float((dp - dj).abs().max()) <= PARAM_ATOL, name
        assert float((dp - dj).norm()) <= UPDATE_RTOL * float(dj.norm()), name


@pytest.mark.parametrize("left_out", [(), ("h.1.",)])
def test_only_the_vision_tower_may_go_without_a_gradient(left_out):
    """A loss that reaches every parameter but the vision tower steps
    (accum 2), the tower's values unchanged and every other moved; one that also leaves out
    a trunk layer raises, naming that layer's parameters."""
    _, _, _, pnp = jax_tiny()
    model = port_model(pnp, **_NO_DROP)
    skip = ("vision_encoder.",) + left_out
    z = torch.zeros(2, 1, 8, dtype=torch.int64)
    batch = {"rl": TBatch(tokens=z, position_id=z, loss_mask=z.float(),
                          label=z)}

    def loss_fn(micro, generator):
        return sum((p.float().square() + p.float()).sum()
                   for n, p in model.named_parameters()
                   if not n.startswith(skip))

    state = tstep.init_train_state(
        model, tcfg.OptimizerConfig(lr=1e-4, lr_warmup_iters=1), 20)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = tstep.make_train_step(model, loss_fn=loss_fn)
    if left_out:
        with pytest.raises(RuntimeError, match="h.1."):
            step(state, batch, torch.Generator())
        return
    for _ in range(2):     # the warmup's first lr is 0
        state, _ = step(state, batch, torch.Generator())
    assert state.step == 2
    for n, p in model.named_parameters():
        moved = not torch.equal(p, before[n])
        assert moved != n.startswith("vision_encoder."), n


# ---- samplers, loader, trainer ---------------------------------------------

def test_random_sampler_and_mixture_counts_match_jax():
    for consumed in (0, 7, 23):
        a = iter(js.RandomSampler(10, consumed, 3, 1, 2, seed=5))
        b = iter(ts.RandomSampler(10, consumed, 3, 1, 2, seed=5))
        assert [next(a) for _ in range(9)] == [next(b) for _ in range(9)]
    for weights, micro in (({"rl": 1.0}, 4), ({"rl": 3, "nlp": 1, "ic": 1}, 7),
                           ({"a": 0.01, "b": 0.99}, 2)):
        assert ts.mixture_counts(weights, micro) == js.mixture_counts(
            weights, micro)


def test_stratified_loader_matches_jax():
    def data(n):
        return [{"tokens": np.full(5, i), "label": np.arange(5) + i,
                 "modality": "rl"} for i in range(n)]

    out = []
    for mod in (js, ts):
        ds = {"rl": data(11), "nlp": data(6)}
        samplers = {"rl": mod.RandomSampler(11, 0, 3, 0, 1, seed=2),
                    "nlp": mod.RandomSampler(6, 0, 1, 0, 1, seed=2)}
        loader = mod.StratifiedGatoLoader(ds, samplers, {"rl": 3, "nlp": 1},
                                          accum_steps=2, num_threads=1)
        out.append([next(loader) for _ in range(4)])
        loader.stop()
    for bj, bt in zip(*out):
        assert bj.keys() == bt.keys()
        for m in bj:
            assert bt[m]["tokens"].shape == (2, bj[m]["tokens"].shape[1], 5)
            for k in bj[m]:
                np.testing.assert_array_equal(bt[m][k], bj[m][k])


def test_trainer_runs_and_logs(tmp_path):
    """Three tiny steps through Trainer.train() on the CPU over the
    stratified loader of an RL dataset: one log record a step with a finite
    loss and tokens/sec, the eval hook at its interval; with a save_dir the
    final checkpoint and metrics.jsonl land there."""
    from bdm_db1_tpu_torch.data.rl_dataset import (
        RLFullDataset, RLTokenizerSuite, TrajectoryStore)
    from bdm_db1_tpu_torch.eval.envs import FakeContinuousEnv
    from bdm_db1_tpu_torch.tokenizers.scalar import ScalarTokenizer

    _, _, _, pnp = jax_tiny()
    model = port_model(pnp)
    cfg = tcfg.db1_tiny(dtype="float32")
    cfg.train = dataclasses.replace(cfg.train, train_iters=3, log_interval=1,
                                    eval_interval=2, micro_batch_size=2,
                                    save_dir=str(tmp_path))
    store = TrajectoryStore.from_flat_dataset(
        FakeContinuousEnv(5, 2, episode_len=60, seed=1).make_dataset(3))
    ds = RLFullDataset("fake", store, RLTokenizerSuite(
        cfg.vocab.layout(), ScalarTokenizer(cfg.vocab.num_continuous_bin)),
        cfg.data.seq_length, seed=0)
    loader = ts.StratifiedGatoLoader(
        {"rl": ds}, {"rl": ts.RandomSampler(len(ds), 0, 2, 0, 1, seed=3)},
        {"rl": 2}, accum_steps=2, num_threads=1)
    evals = []
    state = tstep.init_train_state(model, cfg.train.optimizer,
                                   cfg.train.train_iters)
    trainer = Trainer(cfg, model, tstep.make_train_step(model), state, loader,
                      eval_fn=lambda st, it: evals.append(it) or {"x": 1.0})
    trainer.train()
    loader.stop()
    recs = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if "train/loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3]
    assert all(np.isfinite(r["train/loss"]) and r["train/tokens_per_sec"] > 0
               for r in train)
    assert evals == [2] and trainer.state.step == 3
    assert trainer.ckpt.all_steps() == [3]
    assert (tmp_path / "3" / "client.json").read_text() == '{"iteration": 3}'
