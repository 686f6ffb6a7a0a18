"""Text, caption and VQA generation in the port against the JAX package's
(db1_tiny, f32, CPU, same weights): ``decode_text_kv`` (the ring step and
the aligned prompt) against JAX's ``trunk_kv`` steps, greedy
``TextGenerator`` chains, top-k 1 and a one-token nucleus equal to JAX's
greedy chains, sampled draws inside their filters, ``CaptionGenerator``,
``evaluate_ic`` and ``evaluate_vqa`` (token and string scoring) equal to
JAX's, the metrics on fixed strings (tests/test_ic_vqa.py:135, :153), and
the profiling and NaN tools (tests/test_drivers.py:218)."""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdm_db1_tpu.models.transformer_xl import TransformerXL as JaxTXL
from torch_port_helpers import jax_tiny, one_thread, port_model

# decode_text_kv against trunk_kv (f32): relative to the largest JAX logit
# (tests/test_parity.py's bar)
TEXT_LOGIT_TOL = 2e-4
HW = 32             # 2 x 2 patches of 16
EOS = 0


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """(jax model, params, port weights as numpy, layout): the JAX model
    initialised with its vision subtree."""
    cfg, jm, params, pnp = jax_tiny("off", vision=True)
    return jm, params, pnp, cfg.vocab.layout()


@pytest.mark.parametrize("same_length,prompt,flash", [
    (True, 5, "on"), (False, 5, "off"), (True, 40, "on"),
    (False, 40, "on")])
def test_text_steps_match_trunk_kv(same_length, prompt, flash):
    """A prompt (5 tokens: the ring; 40, longer than mem_len 32 and
    MAX_PRIME_Q: the aligned route), then 8 one-token steps over the ring
    against JAX's ``decode_text_kv`` over its aligned cache: every step's
    logits within the bar."""
    cfg, jm, params, pnp = jax_tiny("off", vision=True,
                                    same_length=same_length)
    tm = port_model(pnp, flash, same_length=same_length)
    B = 2
    rng = np.random.RandomState(prompt)
    toks = rng.randint(1, cfg.vocab.text_vocab_size, (B, prompt + 8))
    step = jax.jit(lambda p, t, c: jm.apply(
        {"params": p}, t, c, method=JaxTXL.decode_text_kv))
    jc = jm.apply({"params": params}, B, method=JaxTXL.init_kv_cache)
    tc = tm.init_kv_cache(B)
    spans = [(0, prompt)] + [(prompt + i, prompt + i + 1) for i in range(8)]
    for a, b in spans:
        lj, jc = step(params, jnp.asarray(toks[:, a:b]), jc)
        lt, tc = tm.decode_text_kv(torch.from_numpy(toks[:, a:b]), tc)
        lj = np.asarray(lj)
        err = np.abs(lt.numpy() - lj).max() / np.abs(lj).max()
        assert err <= TEXT_LOGIT_TOL, (a, b, err)
    # a prompt longer than mem_len leaves the aligned cache at cursor 0
    M = cfg.model.mem_len
    assert tc["cursor"] == (8 if prompt > M else (prompt + 8) % M)
    # the ring, rotated to age order, holds JAX's aligned cache
    aligned = tm.align_ring_cache(tc)
    for key in "kv":
        np.testing.assert_allclose(aligned[key].numpy(), np.asarray(jc[key]),
                                   rtol=0, atol=2e-4)


def _jax_greedy(jm, params, layout, prompts, max_tokens):
    from bdm_db1_tpu.eval.generate import TextGenerator as JGen

    return JGen(jm, params, layout, eos_token_id=EOS,
                max_tokens=max_tokens).generate(prompts)


@pytest.mark.parametrize("kw", [
    dict(), dict(temperature=1.0, top_k=1), dict(temperature=0.7,
                                                 top_p=1e-6)],
    ids=["greedy", "top_k-1", "top_p-one-token"])
@pytest.mark.parametrize("plen", [3, 40])
def test_text_generator_matches_jax_greedy(tiny, kw, plen):
    """Greedy chains equal JAX's; top-k 1 and a nucleus that keeps one
    token run the filters and the draw, and equal JAX's greedy chains."""
    from bdm_db1_tpu_torch.eval.generate import TextGenerator

    jm, params, pnp, layout = tiny
    prompts = np.random.RandomState(plen).randint(1, 200, (2, plen))
    want = _jax_greedy(jm, params, layout, prompts, 8)
    gen = TextGenerator(port_model(pnp, "on"), layout, EOS, max_tokens=8,
                        **kw)
    raw = gen.generate_tokens(prompts)
    assert raw.shape == (2, 8)
    assert gen.generate(prompts) == want


def test_generate_text_pads_with_eos_as_jax(tiny):
    from bdm_db1_tpu.eval.generate import TextGenerator as JGen
    from bdm_db1_tpu.tokenizers.text import ByteTextTokenizer as JTok
    from bdm_db1_tpu_torch.eval.generate import TextGenerator
    from bdm_db1_tpu_torch.tokenizers.text import ByteTextTokenizer

    jm, params, pnp, layout = tiny
    texts = ["ab", "xyz", "a longer prompt"]
    jtok, ttok = JTok(), ByteTextTokenizer()
    want = JGen(jm, params, layout, jtok.eos_token_id,
                max_tokens=6).generate_text(jtok, texts)
    got = TextGenerator(port_model(pnp, "off"), layout, ttok.eos_token_id,
                        max_tokens=6).generate_text(ttok, texts)
    assert got == want and len(got) == 3


def test_sampled_draws_stay_in_their_filters():
    """``_sample`` on seeded logits: top-k draws are among the k largest,
    top-p draws inside the nucleus (the smallest set of largest logits
    whose probability reaches p); one generator seed gives one draw."""
    from bdm_db1_tpu_torch.eval.generate import _sample

    rng = np.random.RandomState(0)
    logits = torch.from_numpy(rng.randn(256, 50).astype(np.float32) * 3)
    for temperature in (0.5, 1.5):
        got = _sample(logits, torch.Generator().manual_seed(1), temperature,
                      5, 0.0)
        top = torch.topk(logits, 5, dim=-1).indices
        assert (top == got[:, None]).any(-1).all()
        got = _sample(logits, torch.Generator().manual_seed(2), temperature,
                      0, 0.6)
        order = torch.argsort(logits, dim=-1, descending=True)
        probs = torch.softmax(logits / temperature, -1).gather(-1, order)
        keep = (probs.cumsum(-1) - probs) < 0.6
        rank = (order == got[:, None]).float().argmax(-1)
        assert keep.gather(-1, rank[:, None]).all()
        assert len(set(got.tolist())) > 1
    a = _sample(logits, torch.Generator().manual_seed(3), 1.0, 0, 0.0)
    b = _sample(logits, torch.Generator().manual_seed(3), 1.0, 0, 0.0)
    assert torch.equal(a, b)
    assert torch.equal(_sample(logits, None, 0.0, 5, 0.5),
                       logits.argmax(-1))


def test_sampled_generation_follows_its_generator(tiny):
    from bdm_db1_tpu_torch.eval.generate import TextGenerator

    _, _, pnp, layout = tiny
    gen = TextGenerator(port_model(pnp, "off"), layout, EOS, max_tokens=12,
                        temperature=1.5, top_k=50)
    prompts = np.array([[5, 6, 7]])
    draws = [gen.generate_tokens(prompts, torch.Generator().manual_seed(s))
             for s in (1, 1, 2)]
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    assert int(draws[2].max()) < layout.text_vocab_size


# ---- captions and VQA ------------------------------------------------------

@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """tests/test_ic_vqa.py's COCO and VQA fixtures with inline pixels (5
    images, two references each; 5 questions, ten human answers each)."""
    tmp = tmp_path_factory.mktemp("icvqa")
    rng = np.random.RandomState(0)
    images = [{"id": i, "file_name": f"{i}.jpg",
               "pixels": rng.rand(3, HW, HW).astype(np.float32).tolist()}
              for i in range(5)]
    anns = [{"image_id": i, "caption": [10 + i, 20 + c, 30, 0]}
            for i in range(5) for c in range(2)]
    prompt = {"prompt_items": [[1, 2], [3], [4]]}
    ic = tmp / "captions.json"
    ic.write_text(json.dumps({"images": images, "annotations": anns,
                              **prompt}))
    answers = ["7", "seven", "8", "the 7", "9"]
    vanns = [{"question_id": 100 + i, "image_id": i, "answer_type": "other",
              "question_type": "what",
              "answers": [{"answer": answers[i]}] * 6
              + [{"answer": "7"}] * 4,
              "answer_tokens": [[7, 0]]} for i in range(5)]
    qs = [{"question_id": 100 + i, "image_id": i,
           "question_tokens": [40 + i] * (1 + i % 3)} for i in range(5)]
    vann, vq = tmp / "vqa_ann.json", tmp / "vqa_q.json"
    vann.write_text(json.dumps({"annotations": vanns, "images": images,
                                **prompt}))
    vq.write_text(json.dumps({"questions": qs}))
    return str(ic), str(vann), str(vq)


def _datasets(fixtures, kind):
    """The eval split of ``kind`` in both packages: (jax, port)."""
    from bdm_db1_tpu.data import vit_dataset as jvit
    from bdm_db1_tpu_torch.data import vit_dataset as tvit

    ic, vann, vq = fixtures
    kw = dict(n_position=64, image_size=HW, patch_size=16, eos_token_id=EOS,
              train=False)
    if kind == "ic":
        return (jvit.get_ic_coco_dataset("", ic, **kw),
                tvit.get_ic_coco_dataset("", ic, **kw))
    return (jvit.get_vqa_v2_dataset("", vann, vq, **kw),
            tvit.get_vqa_v2_dataset("", vann, vq, **kw))


@pytest.mark.parametrize("flash", ["on", "off"])
def test_caption_generator_matches_jax(tiny, fixtures, flash):
    """Greedy captions of 5 images (prompt 2 + 4 patches + one EOS seed,
    then 29 ring steps) equal JAX's, and so do a 3-token text prefix's."""
    from bdm_db1_tpu.eval.evaluate_ic import CaptionGenerator as JCap
    from bdm_db1_tpu_torch.eval.evaluate_ic import (
        MAX_CAPTION_TOKENS, CaptionGenerator,
    )

    jm, params, pnp, layout = tiny
    _, tds = _datasets(fixtures, "ic")
    items = [tds.dataset[i] for i in range(5)]
    prompt = np.stack([it["prompt"] for it in items])
    images = np.stack([np.transpose(it["img"], (1, 2, 0)) for it in items])
    jgen = JCap(jm, params, layout, EOS)
    tgen = CaptionGenerator(port_model(pnp, flash), layout, EOS)
    assert tgen.max_tokens == MAX_CAPTION_TOKENS == 30
    for seed in (np.full((5, 1), EOS), np.tile([[50, 51, 52]], (5, 1))):
        raw = tgen.generate_tokens(prompt, images, seed)
        assert raw.shape == (5, MAX_CAPTION_TOKENS)
        assert tgen.generate(prompt, images, seed) == jgen.generate(
            prompt, images, seed)


def test_evaluate_ic_matches_jax(tiny, fixtures):
    from bdm_db1_tpu.eval.evaluate_ic import evaluate_ic as jeval
    from bdm_db1_tpu_torch.eval.evaluate_ic import evaluate_ic

    jm, params, pnp, layout = tiny
    jds, tds = _datasets(fixtures, "ic")
    for n, bs in ((0, 2), (4, 3)):
        want = jeval(jm, params, jds, layout, EOS, num_samples=n,
                     batch_size=bs)
        got = evaluate_ic(port_model(pnp, "off"), tds, layout, EOS,
                          num_samples=n, batch_size=bs)
        assert got == want


@pytest.mark.parametrize("strings", [False, True], ids=["tokens", "strings"])
def test_evaluate_vqa_matches_jax(tiny, fixtures, strings):
    """Questions of 3-5 tokens right-padded with EOS in a batch; answers
    scored as token sequences (no tokenizer) or as byte strings."""
    from bdm_db1_tpu.eval.evaluate_vqa import evaluate_vqa as jeval
    from bdm_db1_tpu.tokenizers.text import ByteTextTokenizer as JTok
    from bdm_db1_tpu_torch.eval.evaluate_vqa import (
        MAX_ANSWER_TOKENS, evaluate_vqa,
    )
    from bdm_db1_tpu_torch.tokenizers.text import ByteTextTokenizer

    jm, params, pnp, layout = tiny
    jds, tds = _datasets(fixtures, "vqa")
    assert MAX_ANSWER_TOKENS == 10
    want = jeval(jm, params, jds, layout, EOS,
                 text_tokenizer=JTok() if strings else None, batch_size=3)
    got = evaluate_vqa(port_model(pnp, "on"), tds, layout, EOS,
                       text_tokenizer=ByteTextTokenizer() if strings
                       else None, batch_size=3)
    assert got == want and got["num_evaluated"] == 5.0


def test_metrics_match_jax():
    """BLEU, CIDEr-D, ROUGE-L, the caption dict, the VQA accuracy, answer
    normalization and VQAEval on fixed strings and on seeded token
    corpora: equal to the JAX package's, value for value."""
    from bdm_db1_tpu.eval import metrics as jmx
    from bdm_db1_tpu_torch.eval import metrics as tmx

    hyp = [["a", "cat", "on", "a", "mat"]]
    refs = [[["a", "cat", "on", "a", "mat"], ["a", "cat", "sits"]]]
    b = tmx.corpus_bleu(hyp, refs)
    assert b[0] == pytest.approx(1.0) and b[3] == pytest.approx(1.0)
    assert tmx.rouge_l(hyp, refs) == pytest.approx(1.0)
    cases = [(hyp, refs), ([["a", "dog"]], refs)]
    rng = np.random.RandomState(0)
    for _ in range(3):
        n = 6
        cases.append((
            [list(rng.randint(0, 9, rng.randint(0, 9))) for _ in range(n)],
            [[list(rng.randint(0, 9, rng.randint(1, 9)))
              for _ in range(rng.randint(1, 4))] for _ in range(n)]))
    for h, r in cases:
        assert tmx.corpus_bleu(h, r) == jmx.corpus_bleu(h, r)
        assert tmx.cider_d(h, r) == jmx.cider_d(h, r)
        assert tmx.rouge_l(h, r) == jmx.rouge_l(h, r)
        res, gts = dict(enumerate(h)), dict(enumerate(r))
        assert tmx.evaluate_captions(res, gts) == \
            jmx.evaluate_captions(res, gts)
    scores = tmx.evaluate_captions(
        {0: hyp[0], 1: ["a", "dog", "runs"]},
        {0: refs[0], 1: [["a", "dog", "runs"], ["the", "dog", "running"]]})
    assert scores["Bleu_1"] > 0.9 and scores["CIDEr"] > 0
    for ans, humans in (("7", ["7"] * 10), ("8", ["7"] * 10),
                        ("7", ["7"] * 2 + ["8"] * 8), ("The cat", ["cat"]),
                        ("Two dogs!", ["2 dogs", "two dogs"] * 5),
                        ("dont", ["don't"] * 3), ("x", [])):
        assert tmx.vqa_accuracy(ans, humans) == jmx.vqa_accuracy(ans, humans)
        assert tmx.normalize_answer(ans) == jmx.normalize_answer(ans)
    assert tmx.vqa_accuracy("7", ["7"] * 10) == 1.0
    assert tmx.vqa_accuracy("The cat", ["cat"]) == 1.0

    def qa(d):
        return types.SimpleNamespace(qa=d)

    gt = qa({1: {"answers": [{"answer": "7"}] * 10, "answer_type": "num"},
             2: {"answers": [{"answer": "yes"}] * 3, "answer_type": "y/n"},
             3: {"answers": [{"answer": "red"}] * 5}})
    res = qa({1: {"answer": "7"}, 2: {"answer": "no"}, 3: {"answer": "Red"}})
    jev, tev = jmx.VQAEval(gt, res), tmx.VQAEval(gt, res)
    assert tev.evaluate() == jev.evaluate()
    assert tev.accuracy == jev.accuracy and "num" in tev.accuracy


# ---- tooling -----------------------------------------------------------------

def test_debugging_tools_match_jax(capsys):
    """tests/test_drivers.py:218's checks: check_nan names the non-finite
    leaves as the JAX package's does, global_finite on tensors and trees."""
    from bdm_db1_tpu.utils.debugging import check_nan as jcheck
    from bdm_db1_tpu_torch.utils.debugging import (
        check_nan, global_finite, warn_on_overflow,
    )

    bad = {"a": np.array([1.0, np.nan])}
    assert check_nan(bad) == ["params['a']"]
    tree = {"w": {"b": np.ones(2), "a": np.array([np.inf])},
            "list": [np.zeros(1), np.array([np.nan])], "ok": np.ones(3)}
    assert check_nan(tree, prefix="grads") == jcheck(tree, prefix="grads")
    assert check_nan({"x": torch.tensor([1.0, float("nan")],
                                        dtype=torch.bfloat16)}) == [
        "params['x']"]
    assert not bool(global_finite(torch.tensor([1.0, float("nan")])))
    assert bool(global_finite({"x": torch.ones(3), "i": torch.arange(3)}))
    assert not bool(global_finite({"x": [torch.ones(2),
                                         torch.tensor([float("inf")])]}))
    assert bool(global_finite({}))
    capsys.readouterr()
    warn_on_overflow(torch.tensor(float("nan")))
    warn_on_overflow(1.0)
    assert capsys.readouterr().out.count("Loss Overflow") == 1


def test_profiling_tools(tmp_path):
    from bdm_db1_tpu_torch.utils.profiling import (
        StepTimer, annotate, device_memory_stats, profile_trace,
    )

    t = StepTimer(tokens_per_step=100)
    t.tick()
    t.tick()
    s = t.summary()
    assert s["steps_per_sec"] > 0 and s["tokens_per_sec"] == pytest.approx(
        100 * s["steps_per_sec"])
    assert StepTimer().tokens_per_sec == 0.0
    assert device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert device_memory_stats() == {}
    with profile_trace(str(tmp_path / "trace")):
        with annotate("region"):
            torch.ones(4).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(e.get("name") == "region" for e in trace["traceEvents"])
