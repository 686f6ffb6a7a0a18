"""Rematerialization in the port (``remat``, ``remat_policy``), on the CPU
at db1_tiny in f32 with dropout on: under each policy the loss, the
gradients and the training generator's state after a step are bitwise
those without remat, through K3-K5's plain route (seq 1024) and through
``rel_attention`` (seq 64, attention dropout on); K3's forward runs twice a
layer under "full" and once under "dots" and "dots_narrow" (its outputs
kept); ``behavior_clone`` at 24 layers defaults to remat and equals
``remat=False``.

The JAX package's remat (``nn.remat`` with ``remat_policy_for``) changes
what is stored, not what is computed; here the port with remat is held to
the port without it, bit for bit."""

import functools

import numpy as np
import pytest
import torch

from torch_port_helpers import one_thread

POLICIES = ("full", "dots", "dots_narrow")
# (attention_impl, seq, dropattn): K3-K5's plain route at the kernel gate's
# shape, and rel_attention with attention dropout
ROUTES = {"kernel": ("pallas", 1024, 0.0), "rel_attention": ("xla", 64, 0.1)}
# K3 forwards a layer and a micro-batch
K3_FORWARDS = {None: 1, "full": 2, "dots": 1, "dots_narrow": 1}
# rows a micro-batch by route
ROWS = {"kernel": 1, "rel_attention": 2}


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


class _Counting:
    """Counts the calls of a module-level function while patched in."""

    def __init__(self, fn):
        self.fn, self.n = fn, 0

    def __call__(self, *a, **k):
        self.n += 1
        return self.fn(*a, **k)


def _model(route: str, **over):
    from bdm_db1_tpu_torch.core import config as tcfg
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL

    impl, seq, dropattn = ROUTES[route]
    cfg = tcfg.db1_tiny(dtype="float32", n_position=seq, attention_impl=impl,
                        drop=0.1, embd_pdrop=0.1, dropattn=dropattn, **over)
    return TransformerXL(cfg.model, cfg.vocab, device="cpu",
                         generator=torch.Generator().manual_seed(0))


def _batch(model, seq: int, seed: int = 0, rows: int = 2):
    from bdm_db1_tpu_torch.data.input_specs import RLTaskBatch

    rng = np.random.RandomState(seed)
    shape = (rows, seq)
    tok = torch.as_tensor(rng.randint(0, model.layout.total_vocab_size,
                                      shape))
    return {"rl": RLTaskBatch(
        tokens=tok, position_id=torch.as_tensor(rng.randint(0, 8, shape)),
        loss_mask=torch.as_tensor(rng.rand(*shape) < 0.5).float(),
        label=tok)}


def _step(route: str, policy, monkeypatch):
    """One loss and gradient of a fresh model under ``policy`` (None: no
    remat) with a seeded generator: (loss, gradients, generator state after,
    K3 forwards, K4/K5 backwards)."""
    from bdm_db1_tpu_torch.ops import flash_rel_attention as fra

    model = _model(route)
    model.cfg.remat = policy is not None
    model.cfg.remat_policy = policy or "full"
    fwd = _Counting(fra.flash_rel_attention_plain)
    bwd = _Counting(fra.flash_rel_attention_bwd_plain)
    monkeypatch.setattr(fra, "flash_rel_attention_plain", fwd)
    monkeypatch.setattr(fra, "flash_rel_attention_bwd_plain", bwd)
    gen = torch.Generator().manual_seed(7)
    _, loss = model(_batch(model, ROUTES[route][1], rows=ROWS[route]),
                    compute_loss=True,
                    deterministic=False, loss_only=True, generator=gen)
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    monkeypatch.undo()
    return loss.detach(), grads, gen.get_state(), fwd.n, bwd.n


@functools.lru_cache(maxsize=None)
def _baseline(route: str):
    mp = pytest.MonkeyPatch()
    try:
        return _step(route, None, mp)
    finally:
        mp.undo()


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_is_bitwise_no_remat(route, policy, monkeypatch):
    """Loss, every gradient and the generator state bitwise equal to the
    step without remat; K3 forwards 2 / 1 / 1 a layer (the plain route's
    calls), K4 + K5 once a layer either way; rel_attention takes no K3."""
    L = _model(route).cfg.n_layer
    loss0, grads0, gen0, fwd0, bwd0 = _baseline(route)
    loss, grads, gen, fwd, bwd = _step(route, policy, monkeypatch)
    assert torch.equal(loss, loss0)
    assert len(grads) == len(grads0)
    for i, (g, g0) in enumerate(zip(grads, grads0)):
        assert (g is None) == (g0 is None), i
        assert g is None or torch.equal(g, g0), i
    assert torch.equal(gen, gen0)
    if route == "kernel":
        assert (fwd0, bwd0) == (L, L)
        assert (fwd, bwd) == (K3_FORWARDS[policy] * L, L)
    else:
        assert fwd == bwd == fwd0 == bwd0 == 0


def test_remat_policies_name_what_they_keep():
    """The policies' decisions: "dots" keeps every mm/addmm and K3's op,
    "dots_narrow" only the products at most n_embed wide and K3's op;
    "full" has no policy (keeps nothing); anything else raises."""
    from torch.utils.checkpoint import CheckpointPolicy

    from bdm_db1_tpu_torch.models import transformer_xl as txl
    from bdm_db1_tpu_torch.ops.flash_rel_attention import K3_OP

    aten = torch.ops.aten
    x, w_o = torch.zeros(4, 64), torch.zeros(64, 64)
    w_qkv = torch.zeros(64, 192)
    save, redo = CheckpointPolicy.MUST_SAVE, CheckpointPolicy.PREFER_RECOMPUTE
    assert txl.remat_policy("full", 64) is None
    with pytest.raises(ValueError, match="remat_policy"):
        txl.remat_policy("offload", 64)
    for name, qkv in (("dots", save), ("dots_narrow", redo)):
        policy = txl.remat_policy(name, 64).args[0]
        assert policy(None, aten.mm.default, x, w_qkv) == qkv
        assert policy(None, aten.addmm.default, x[0], x, w_qkv) == qkv
        assert policy(None, aten.mm.default, x, w_o) == save
        assert policy(None, K3_OP, x) == save
        assert policy(None, aten.bmm.default, x[None], w_o[None]) == redo
        assert policy(None, aten.gelu.default, x) == redo


def test_train_step_under_remat_is_bitwise(monkeypatch):
    """``make_train_step`` (two micro-batches, the AdamW chain) under
    "dots_narrow" through rel_attention: the loss, every updated parameter
    and the generator state equal the step without remat."""
    from bdm_db1_tpu_torch.core.config import OptimizerConfig
    from bdm_db1_tpu_torch.train.step import init_train_state, make_train_step

    out = []
    for remat in (True, False):
        model = _model("rel_attention", remat=remat,
                       remat_policy="dots_narrow")
        one = _batch(model, 64)["rl"]
        two = _batch(model, 64, seed=1)["rl"]
        batch = {"rl": type(one)(**{
            k: torch.stack([getattr(one, k), getattr(two, k)])
            for k in ("tokens", "position_id", "loss_mask", "label")})}
        state = init_train_state(model, OptimizerConfig(), 10)
        gen = torch.Generator().manual_seed(3)
        state, met = make_train_step(model)(state, batch, gen)
        out.append((float(met["loss"]), [p.detach().clone()
                                         for p in model.parameters()],
                    gen.get_state()))
    (la, pa, ga), (lb, pb, gb) = out
    assert la == lb and torch.equal(ga, gb)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))


def test_behavior_clone_defaults_to_remat(monkeypatch):
    """A narrow 24-layer config: ``behavior_clone`` turns remat on by
    default (every layer checkpointed), leaves the model's flag as it was,
    and ends with the weights of ``remat=False``, bit for bit."""
    from bdm_db1_tpu_torch.core import config as tcfg
    from bdm_db1_tpu_torch.data.rl_dataset import (
        RLFullDataset, RLTokenizerSuite, TrajectoryStore,
    )
    from bdm_db1_tpu_torch.eval.envs import FakeContinuousEnv
    from bdm_db1_tpu_torch.models import transformer_xl as txl
    from bdm_db1_tpu_torch.tokenizers.scalar import ScalarTokenizer
    from bdm_db1_tpu_torch.train.bc import REMAT_LAYERS, behavior_clone

    cfg = tcfg.db1_tiny(n_layer=REMAT_LAYERS, n_embed=32, n_head=2,
                        n_inner=64, dtype="float32", n_position=32)
    assert cfg.model.drop > 0 and not cfg.model.remat
    suite = RLTokenizerSuite(cfg.vocab.layout(),
                             ScalarTokenizer(cfg.vocab.num_continuous_bin))
    ds = RLFullDataset("fake", TrajectoryStore.from_flat_dataset(
        FakeContinuousEnv(obs_dim=4, act_dim=2, episode_len=20,
                          seed=7).make_dataset(3)),
        suite, seq_length=32, use_prompt=False, seed=0)
    remat = _Counting(txl._remat_layer)
    monkeypatch.setattr(txl, "_remat_layer", remat)
    weights = []
    for kw in ({}, {"remat": False}):
        model = txl.TransformerXL(cfg.model, cfg.vocab, device="cpu",
                                  generator=torch.Generator().manual_seed(0))
        remat.n = 0
        behavior_clone(cfg, model, ds, steps=2, micro=2, lr=1e-3,
                       distinct_batches=1, **kw)
        assert remat.n == (2 * REMAT_LAYERS if not kw else 0), kw
        assert not model.cfg.remat
        weights.append([p.detach().clone() for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*weights))
