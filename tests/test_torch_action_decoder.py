"""The port's RL-evaluation slice as a whole against the JAX package: the
tokenizer and wrapper bit for bit, greedy action chains of ActionDecoder
exactly, and evaluate_envs_lockstep's records exactly, from the same
weights (db1_tiny, f32, CPU)."""

import copy

import numpy as np
import pytest
import torch

from torch_port_helpers import (
    episode_primes, fake_env_datasets, greedy_chain, jax_tiny, one_thread,
    port_model,
)

OBS, ACT = 4, 2


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg, model, params, pnp = jax_tiny("off")
    jt, tt = fake_env_datasets(3, OBS, ACT, episode_len=6)
    return cfg, model, params, pnp, jt, tt


def test_scalar_tokenizer_matches_jax():
    from bdm_db1_tpu.tokenizers.scalar import ScalarTokenizer as J
    from bdm_db1_tpu_torch.tokenizers.scalar import ScalarTokenizer as T

    x = np.random.RandomState(0).randn(50, 7).astype(np.float32) * 3
    j, t = J(64), T(64)
    for is_action in (False, True):
        bj = j.discretize_np(x, is_action)
        np.testing.assert_array_equal(bj, t.discretize_np(x, is_action))
        np.testing.assert_array_equal(j.decode_np(bj, is_action),
                                      t.decode_np(bj, is_action))


def test_tokenized_env_matches_jax(setup):
    *_, jt, tt = setup
    rng_j, rng_t = np.random.RandomState(3), np.random.RandomState(3)
    for a, b in zip(jt, tt):
        pj, _ = a.get_prompt(strict_length=True, rng=rng_j)
        pt, _ = b.get_prompt(strict_length=True, rng=rng_t)
        np.testing.assert_array_equal(pj, pt)
        oj, _, _ = a.reset()
        ot, _, _ = b.reset()
        np.testing.assert_array_equal(oj, ot)
    raws = [np.random.RandomState(i).randn(OBS).astype(np.float32)
            for i in range(3)]
    np.testing.assert_array_equal(jt[0].encode_obs_batch(raws)[0],
                                  tt[0].encode_obs_batch(raws)[0])
    assert (jt[0].obs_length, jt[0].action_length) == \
        (tt[0].obs_length, tt[0].action_length)


@pytest.mark.parametrize("flash", ["on", "off"])
def test_greedy_chains_match_jax(setup, flash):
    """Five env steps at batch 3 with defer_last: the episode-start prime
    runs in chunked ring slices (75 tokens > mem_len 32), the rest are
    [deferred action || obs || sep] primes."""
    from bdm_db1_tpu.eval.decode import build_decoder_for_env as jbuild
    from bdm_db1_tpu_torch.eval.decode import build_decoder_for_env as tbuild

    cfg, model, params, pnp, jt, tt = setup
    primes = episode_primes(jt, 0, 5, OBS)
    np.testing.assert_array_equal(primes[0],
                                  episode_primes(tt, 0, 5, OBS)[0])
    ref = greedy_chain(jbuild(model, params, jt[0]), primes, defer=True)
    dec = tbuild(port_model(pnp, flash), tt[0])
    assert dec.defers
    got = greedy_chain(dec, primes, defer=True)
    assert len(got) == 5 and got[0].shape == (3, ACT)
    for k, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(a, b, err_msg=f"step {k}")


def test_fold_path_matches_deferred_path(setup):
    """Without defer_last the last action token gets its own fold forward;
    the action stream is the same."""
    from bdm_db1_tpu_torch.eval.decode import build_decoder_for_env

    *_, pnp, jt, tt = setup
    primes = episode_primes(tt, 1, 4, OBS)
    dec = build_decoder_for_env(port_model(pnp, "off"), tt[0])
    a = greedy_chain(dec, primes, defer=True)
    b = greedy_chain(dec, primes, defer=False)
    for k, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"step {k}")


def test_evaluate_envs_lockstep_matches_jax(setup):
    """Two envs x 3 trials at batch 4, interleave 2: the same records
    (return mean/std, length, trials) as the JAX harness."""
    from bdm_db1_tpu.eval.harness import evaluate_envs_lockstep as jeval
    from bdm_db1_tpu_torch.eval.harness import evaluate_envs_lockstep as teval

    cfg, model, params, pnp, jt, tt = setup
    names = ["cont-a", "cont-b"]

    def maker(tenvs):
        inst = dict(zip(names, tenvs))

        def make(name):
            t = inst[name]
            return type(t)(copy.deepcopy(t.env), t.ds,
                           eval_prompt_strategy=t.eval_prompt_strategy)
        return make

    kw = dict(num_trials=3, batch_size=4, seed=0, max_step_size=4)
    ref = jeval(model, params, names, maker(jt), **kw)
    got = teval(port_model(pnp, "on"), names, maker(tt), **kw)
    assert len(got) == 2
    for r, g in zip(ref, got):
        assert r["env"] == g["env"]
        assert r["num_trials"] == g["num_trials"] == 3
        assert r["length_mean"] == g["length_mean"] == 4.0
        assert r["return_mean"] == pytest.approx(g["return_mean"], abs=1e-9)
        assert r["return_std"] == pytest.approx(g["return_std"], abs=1e-9)


@pytest.mark.parametrize("mask_rank", [1, 2])
def test_fold_env_mask_bias_matches_jax(mask_rank):
    from bdm_db1_tpu.core.config import db1_tiny
    from bdm_db1_tpu.eval.decode import fold_env_mask_bias as jfold
    from bdm_db1_tpu_torch.core import config as port_config
    from bdm_db1_tpu_torch.eval.decode import fold_env_mask_bias as tfold

    jl, tl = db1_tiny().vocab.layout(), port_config.db1_tiny().vocab.layout()
    base = jl.discrete_action_logit_bias(5)
    np.testing.assert_array_equal(base, tl.discrete_action_logit_bias(5))
    mask = np.random.RandomState(mask_rank).randint(
        0, 2, (5,) if mask_rank == 1 else (3, 5))
    np.testing.assert_array_equal(jfold(base, jl, True, 5, mask),
                                  tfold(base, tl, True, 5, mask))
    assert tfold(base, tl, False, 5, mask) is base


def test_run_batched_episodes_matches_jax(setup):
    """Three envs in one lockstep batch until their episodes end: the same
    returns and lengths as the JAX harness."""
    from bdm_db1_tpu.eval.decode import build_decoder_for_env as jbuild
    from bdm_db1_tpu.eval.harness import run_batched_episodes as jrun
    from bdm_db1_tpu_torch.eval.decode import build_decoder_for_env as tbuild
    from bdm_db1_tpu_torch.eval.harness import run_batched_episodes as trun

    cfg, model, params, pnp, *_ = setup
    # fresh envs: the module's shared ones have been stepped by other tests
    jt, tt = fake_env_datasets(3, OBS, ACT, episode_len=6)
    ref = jrun(jt, jbuild(model, params, jt[0]),
               rng=np.random.RandomState(4))
    got = trun(tt, tbuild(port_model(pnp, "on"), tt[0]),
               rng=np.random.RandomState(4))
    assert [r.episode_length for r in got] == \
        [r.episode_length for r in ref] == [6, 6, 6]
    for r, g in zip(ref, got):
        assert g.episode_return == pytest.approx(r.episode_return, abs=1e-9)
