"""The sharded decode in the port (tests/test_sharded_decode.py's cases), on
the CPU at db1_tiny in f32: a two-rank gloo world at tp 2
(tests/torch_dist_workers.py) decodes with ``ActionDecoder(mesh=...)`` on
each rank's heads, and its greedy chains equal the JAX package's
single-device chains, which tests/test_sharded_decode.py holds equal to
JAX's sharded ones: the ring branch, speculative decode, the kernel
route's plain versions on the local heads, the int8 cache; and the int8
decode weights, which JAX's sharded decode runs (a (2, 4) mesh of the
virtual CPU devices, computed here too): K9's plain version on each
rank's shard, the W8A8 activations scaled by the whole row. Then
``evaluate_rl.main`` with ``eval.sharded_decode`` against one process, the
pool that shards once, and a ``model_parallel`` that does not divide the
heads: the port raises where the JAX decode falls back to its ring
branch."""

import dataclasses

import numpy as np
import pytest
import torch

from bdm_db1_tpu.core.config import MeshConfig as JMesh
from bdm_db1_tpu.core.config import db1_tiny as jdb1_tiny
from bdm_db1_tpu.eval.decode import build_decoder_for_env
from bdm_db1_tpu.eval.envs import FakeContinuousEnv
from bdm_db1_tpu.models.transformer_xl import TransformerXL as JTXL
from bdm_db1_tpu.parallel.mesh import make_mesh as jmake_mesh
from bdm_db1_tpu_torch.core import config as tcfg
from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
from bdm_db1_tpu_torch.parallel import mesh as tmesh
from bdm_db1_tpu_torch.train.convert import load_jax_params
from tests import torch_dist_workers as tw
from tests.test_batched_eval import _setup
from tests.test_speculative import _chain, _episode_primes
from tests.torch_port_helpers import one_thread, to_numpy

TP = 2
MESH = {"model_parallel": TP}
# (name, port/JAX model overrides, act_dim, primes seed, defer)
CASES = (
    ("ring", dict(decode_flash="off"), 2, 0, False),
    ("speculative", dict(decode_flash="off", decode_speculative=True), 3, 2,
     True),
    ("flash", dict(decode_flash="on"), 2, 0, False),
    ("flash_int8_cache", dict(decode_flash="on", decode_cache_dtype="int8"),
     2, 0, False),
    ("int8_weights", dict(decode_flash="on", decode_weight_dtype="int8"), 2,
     0, False),
    ("int8a8_weights", dict(decode_flash="off",
                            decode_weight_dtype="int8a8"), 2, 0, False),
)
# the JAX chain each port chain is held to besides its own: the ring
# chain for the flash route (tests/test_sharded_decode.py)
ALSO = {"flash": "ring"}
# the cases whose JAX chain is also computed on a (2, 4) mesh: the int8
# decode weights, which no JAX test runs on a mesh; for the others
# tests/test_sharded_decode.py holds JAX's sharded chain equal to its
# single-device one
ON_MESH = ("int8_weights", "int8a8_weights")
N_ENVS, OBS_DIM, N_STEPS = 4, 4, 3


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _jax_model(model, **over):
    cfg = jdb1_tiny()
    return JTXL(dataclasses.replace(model.cfg, **over), cfg.vocab, cfg.vision)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX init (tests/test_sharded_decode.py's ``_setup``) as a port
    state dict, the prime streams, and the world that decodes every case
    (started before the JAX chains are computed)."""
    tmp = tmp_path_factory.mktemp("sharded_decode")
    out = {"tmp": tmp, "primes": {}, "tenvs": {}}
    cases, made = [], {}
    for name, over, act_dim, seed, defer in CASES:
        if act_dim not in made:
            made[act_dim] = _setup(FakeContinuousEnv, N_ENVS,
                                   obs_dim=OBS_DIM, act_dim=act_dim,
                                   episode_len=5)
        cfg, model, params, tenvs = made[act_dim]
        primes = _episode_primes(tenvs, seed, N_STEPS, OBS_DIM)
        out["primes"][name], out["tenvs"][name] = primes, tenvs
        cases.append((over, tenvs[0].obs_length, tenvs[0].action_length,
                      primes, defer))
    out.update(model=model, params=params)
    pcfg = tcfg.db1_tiny(dtype="float32")
    port = TransformerXL(pcfg.model, pcfg.vocab, device="cpu")
    load_jax_params(port, to_numpy(params))
    out["sd"] = port.state_dict()
    out["world"] = tw.World(tw.tp_chains, TP, tmp, out["sd"], cases, MESH)
    yield out
    try:
        out["world"].join()
    except RuntimeError:
        pass


@pytest.fixture(scope="module")
def jax_chains(setup):
    """Each case's JAX chain on one device (the speculative case's the
    sequential decoder's, as tests/test_sharded_decode.py holds it) and,
    for ``ON_MESH``, on a (2, 4) mesh."""
    out = {}
    model, params = setup["model"], setup["params"]
    mesh = jmake_mesh(JMesh(data_parallel=2, model_parallel=4))
    for name, over, _, _, defer in CASES:
        tenv, primes = setup["tenvs"][name][0], setup["primes"][name]
        single = {k: v for k, v in over.items() if k != "decode_speculative"}
        out[name] = _chain(build_decoder_for_env(
            _jax_model(model, **single), params, tenv), primes, defer=False)
        if name in ON_MESH:
            out[name + "@mesh"] = _chain(build_decoder_for_env(
                _jax_model(model, **over), params, tenv, mesh=mesh), primes,
                defer=defer)
    return out


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sharded_chain_matches_jax(setup, jax_chains, name):
    """Both ranks' greedy chains equal JAX's single-device chain, JAX's
    sharded chain (``ON_MESH``), and (the flash decoder) JAX's ring
    chain."""
    i = [c[0] for c in CASES].index(name)
    ranks = setup["world"].join()
    refs = [jax_chains[name]]
    if name in ON_MESH:
        refs.append(jax_chains[name + "@mesh"])
    if name in ALSO:
        refs.append(jax_chains[ALSO[name]])
    for r in ranks:
        got = r["chains"][i]
        for ref in refs:
            assert len(got) == len(ref) == N_STEPS
            for k, (a, b) in enumerate(zip(got, ref)):
                np.testing.assert_array_equal(a, b, err_msg=f"{name} {k}")


def test_sharded_cache_holds_the_ranks_heads(setup):
    """The ring cache is allocated at the rank's heads: [L, B, M, H / 2,
    Dh] (tests/test_sharded_decode.py: the carry stays sharded), the
    speculative decoder speculates, and a ``DecoderPool(mesh=...)`` holds
    one sharded model for its decoders."""
    cfg = tcfg.db1_tiny().model
    want = (cfg.n_layer, N_ENVS, cfg.mem_len, cfg.n_head // TP, cfg.d_head)
    for r in setup["world"].join():
        assert r["cache"] == {"k": want, "v": want}
        assert r["pool_sharded"] and r["pool_heads"] == cfg.n_head // TP


def test_sharded_decode_gates_on_head_divisibility():
    """tests/test_sharded_decode.py::test_sharded_flash_gates_on_head_
    divisibility: JAX's decode at tp 8 over db1_tiny's 4 heads falls back
    to its XLA ring branch; the port has one device a process and a rank
    cannot hold a fraction of a head, so a tp that does not divide the
    heads raises ``ValueError`` naming the field, in the model and in the
    sharded decode's driver."""
    cfg = jdb1_tiny(decode_flash="on")
    jm = JTXL(cfg.model, cfg.vocab, cfg.vision,
              decode_mesh=jmake_mesh(JMesh(data_parallel=1,
                                           model_parallel=8)))
    assert not jm._use_flash_decode(1) and not jm._use_flash_decode(4)
    pcfg = tcfg.db1_tiny(dtype="float32", decode_flash="on")
    for size in (3, 8):
        with pytest.raises(ValueError, match="n_head"):
            TransformerXL(pcfg.model, pcfg.vocab, device="cpu",
                          tp=tmesh.TensorParallel(0, size))


# ---- evaluate_rl.main ------------------------------------------------------

@pytest.fixture(scope="module")
def eval_world(tmp_path_factory):
    """tests/test_torch_data_parallel.py's three envs and DeepSpeed
    checkpoint, served by ``evaluate_rl.main`` in the lockstep loop (2
    trials, batch 2) with ``eval.sharded_decode`` over two ranks at tp 2;
    the same config in this one process."""
    from bdm_db1_tpu_torch.eval import envs as te
    from tests.test_torch_data_parallel import ENV_B, _eval_setup

    tmp = tmp_path_factory.mktemp("sharded_eval")
    _, cfg = _eval_setup(tmp)
    cfg.eval = dataclasses.replace(cfg.eval, batched=True, num_trials=2,
                                   batch_size=2)
    sharded = dataclasses.replace(
        cfg, eval=dataclasses.replace(cfg.eval, sharded_decode=True),
        mesh=dataclasses.replace(cfg.mesh, model_parallel=TP),
        train=dataclasses.replace(cfg.train, save_dir=str(tmp / "sharded")))
    world = tw.World(tw.evaluate_rl_main, TP, tmp, sharded,
                     {"fake-continuous-b-v0": ENV_B})
    te.register_env("fake-continuous-b-v0",
                    lambda: te.FakeContinuousEnv(**ENV_B))
    return dict(cfg=cfg, sharded=sharded, world=world, tmp=tmp)


def test_sharded_evaluate_rl_main_matches_one_process(eval_world):
    """``evaluate_rl.main`` with ``eval.sharded_decode`` and
    ``mesh.model_parallel`` 2 in a world of two: both ranks evaluate every
    env (dp 1), the records (one copy, with the suite summary) equal the
    one-process driver's, and results.output holds them once."""
    import contextlib
    import io
    import json

    from bdm_db1_tpu_torch.eval import evaluate_rl as ter

    with contextlib.redirect_stdout(io.StringIO()):
        want = ter.main(eval_world["cfg"], device="cpu")
    ranks = eval_world["world"].join()
    names = list(eval_world["cfg"].eval.env_names)
    assert [r["env"] for r in want[:-1]] == names
    assert ranks[0]["records"] == want
    assert ranks[1]["records"] == want[:-1]     # rank 0 sums the suite up
    assert "suite_summary" in want[-1]
    lines = (eval_world["tmp"] / "sharded" / "results.output").read_text()
    assert lines.splitlines() == [json.dumps(r) for r in want]
