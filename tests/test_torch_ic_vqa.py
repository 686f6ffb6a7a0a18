"""The port's captioning/VQA data, image transforms, image-RL samples and
the pretraining driver on an image mixture, against the JAX package's, on
the CPU: the ``ic``/``vqa`` creators array-equal on the inline-pixel
fixture and on JPEG files, the transform and every AutoAugment op equal
under the same python ``random`` seed, image-RL samples equal,
``pretrain.main`` on an nlp + ic + vqa + image-RL mixture (save, then
resume), and its in-training caption/VQA metrics against the JAX
package's on the same weights."""

import json
import random

import numpy as np
import pytest
import torch

from bdm_db1_tpu.data import autoaugment as jaa
from bdm_db1_tpu.data import rl_dataset as jrd
from bdm_db1_tpu.data import transforms as jtf
from bdm_db1_tpu.data import vit_dataset as jvit
from bdm_db1_tpu.eval import envs as jenvs
from bdm_db1_tpu.tokenizers.scalar import ScalarTokenizer as JScalar
from bdm_db1_tpu_torch.core import config as tcfg
from bdm_db1_tpu_torch.data import autoaugment as taa
from bdm_db1_tpu_torch.data import rl_dataset as trd
from bdm_db1_tpu_torch.data import transforms as ttf
from bdm_db1_tpu_torch.data import vit_dataset as tvit
from bdm_db1_tpu_torch.eval import envs as tenvs
from bdm_db1_tpu_torch.tokenizers.scalar import ScalarTokenizer as TScalar
from bdm_db1_tpu_torch.train import pretrain as tpt
from tests.torch_port_helpers import one_thread

SEQ = 64
HW = 32            # 2 x 2 patches of 16


@pytest.fixture(autouse=True)
def _threads():
    n = one_thread()
    yield
    torch.set_num_threads(n)


def _images(rng, n, inline: bool, root=None):
    """COCO image entries: inline CHW ``pixels`` or JPEG files under
    ``root`` (48 x 40, cropped to HW by the transforms)."""
    out = []
    for i in range(n):
        if inline:
            out.append({"id": i, "file_name": f"{i}.jpg",
                        "pixels": rng.rand(3, HW, HW).astype(
                            np.float32).tolist()})
        else:
            from PIL import Image

            Image.fromarray(rng.randint(0, 255, (40, 48, 3), np.uint8)).save(
                root / f"{i}.jpg")
            out.append({"id": i, "file_name": f"{i}.jpg"})
    return out


def _coco(tmp_path, inline: bool, n=3):
    rng = np.random.RandomState(0)
    anns = [{"image_id": i, "caption": [10 + i, 20 + c, 30, 0]}
            for i in range(n) for c in range(2)]
    path = tmp_path / f"captions_{inline}.json"
    path.write_text(json.dumps({
        "images": _images(rng, n, inline, tmp_path), "annotations": anns,
        "prompt_items": [[1, 2], [3], [4]]}))
    return str(path)


def _vqa(tmp_path, inline: bool, n=2):
    rng = np.random.RandomState(1)
    anns = [{"question_id": 100 + i, "image_id": i, "answer_type": "other",
             "question_type": "what", "answers": [{"answer": "7"}] * 10,
             "answer_tokens": [[7, 0], [8, 9, 0]]} for i in range(n)]
    qs = [{"question_id": 100 + i, "image_id": i,
           "question_tokens": [40 + i, 41]} for i in range(n)]
    ann = tmp_path / f"vqa_ann_{inline}.json"
    ann.write_text(json.dumps({"annotations": anns,
                               "images": _images(rng, n, inline, tmp_path),
                               "prompt_items": [[1, 2], [3], [4]]}))
    q = tmp_path / f"vqa_q_{inline}.json"
    q.write_text(json.dumps({"questions": qs}))
    return str(ann), str(q)


def _same_items(jds, tds, n):
    """Items 0..n-1 of both datasets, each after the same python seed:
    equal keys, equal arrays."""
    for i in range(n):
        random.seed(i)
        a = jds[i]
        random.seed(i)
        b = tds[i]
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], str):
                assert a[k] == b[k], k
            else:
                np.testing.assert_array_equal(np.asarray(b[k]),
                                              np.asarray(a[k]), err_msg=k)
                assert np.asarray(b[k]).dtype == np.asarray(a[k]).dtype, k


@pytest.mark.parametrize("kind", ["ic", "vqa"])
@pytest.mark.parametrize("inline", [True, False], ids=["pixels", "jpeg"])
def test_creators_equal_jax(tmp_path, kind, inline):
    """make_ic_creator / make_vqa_creator of both packages: three splits
    of the same length, items array-equal (the train split draws random
    crops, flips and AutoAugment ops from JPEG files; eval center-crops)."""
    if kind == "ic":
        prefix = f"{tmp_path}:{_coco(tmp_path, inline)}"
    else:
        prefix = f"{tmp_path}:" + ":".join(_vqa(tmp_path, inline))
    kw = dict(n_position=SEQ, image_size=HW, patch_size=16, eos_token_id=0)
    make = {"ic": (jvit.make_ic_creator, tvit.make_ic_creator),
            "vqa": (jvit.make_vqa_creator, tvit.make_vqa_creator)}[kind]
    jsplits = make[0](**kw)(prefix, "90,5,5", SEQ, (1, 1, 1), 0)
    tsplits = make[1](**kw)(prefix, "90,5,5", SEQ, (1, 1, 1), 0)
    for jds, tds in zip(jsplits, tsplits):
        assert len(jds) == len(tds) > 0
        _same_items(jds, tds, len(jds))
    item = tsplits[0][0]
    assert item["images"].shape == (HW, HW, 3)
    assert item["modality"] == kind and item["label"].shape == (SEQ,)


def _pil(w=96, h=64, seed=0):
    from PIL import Image

    rng = np.random.RandomState(seed)
    return Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8))


@pytest.mark.parametrize("train", [True, False])
def test_classification_transform_equal_jax(train):
    for seed in range(6):
        out = []
        for mod in (jtf, ttf):
            random.seed(seed)
            out.append(mod.ClassificationTransform(image_size=32,
                                                   train=train)(_pil(seed=seed)))
        np.testing.assert_array_equal(out[1], out[0])
        assert out[1].shape == (3, 32, 32) and out[1].dtype == np.float32


def test_autoaugment_ops_equal_jax():
    """Every op at every magnitude index, and the policy over 40 calls,
    under the same python seed."""
    img = _pil(64, 64, seed=3)
    assert taa._OPS.keys() == jaa._OPS.keys()
    for name in jaa._OPS:
        np.testing.assert_array_equal(taa._OPS[name][1], jaa._OPS[name][1])
        for idx in range(10):
            outs = []
            for mod in (jaa, taa):
                random.seed(idx)
                fn, mags = mod._OPS[name]
                outs.append(np.asarray(fn(img, mags[idx])))
            np.testing.assert_array_equal(outs[1], outs[0],
                                          err_msg=f"{name}[{idx}]")
    outs = []
    for mod in (jaa, taa):
        random.seed(0)
        pol = mod.ImageNetPolicy()
        outs.append([np.asarray(pol(img)) for _ in range(40)])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("env", ["discrete", "continuous"])
def test_image_rl_samples_equal_jax(env):
    """Packed image-RL samples (prompts on): tokens with their -1 slots,
    labels, position ids, loss masks and the zero-padded NHWC frames."""
    jc, tc = ((jenvs.FakeImageEnv, tenvs.FakeImageEnv) if env == "discrete"
              else (jenvs.FakeContinuousImageEnv,
                    tenvs.FakeContinuousImageEnv))
    cfg = tcfg.db1_tiny()
    layout = cfg.vocab.layout()
    jds = jrd.RLFullDataset(
        "img", jrd.TrajectoryStore.from_flat_dataset(
            jc(hw=HW, episode_len=12, seed=4).make_dataset(3)),
        jrd.RLTokenizerSuite(layout, JScalar(cfg.vocab.num_continuous_bin)),
        seq_length=SEQ, seed=0)
    tds = trd.RLFullDataset(
        "img", trd.TrajectoryStore.from_flat_dataset(
            tc(hw=HW, episode_len=12, seed=4).make_dataset(3)),
        trd.RLTokenizerSuite(layout, TScalar(cfg.vocab.num_continuous_bin)),
        seq_length=SEQ, seed=0)
    assert (tds.observation_dim, tds.transition_num) == (
        jds.observation_dim, jds.transition_num)
    assert len(tds) == len(jds)
    for i in range(len(jds)):
        a, b = jds[i], tds[i]
        assert a.keys() == b.keys() and "images" in b
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{i} {k}")
    assert (b["tokens"] == -1).any()


# ---- the pretraining driver on an image mixture -----------------------------

IMG_ENV = "fake-image-v0"


@pytest.fixture(scope="module")
def image_workspace(tmp_path_factory):
    """A byte corpus, the COCO and VQA fixtures with inline pixels, and the
    registry's fake-image-v0 cache (32 x 32 frames, 4 actions)."""
    from bdm_db1_tpu_torch.data.indexed_dataset import make_builder

    tmp = tmp_path_factory.mktemp("pretrain_img")
    rng = np.random.RandomState(0)
    b = make_builder(str(tmp / "corpus"), vocab_size=256)
    for _ in range(30):
        b.add_document(rng.randint(1, 200, size=60))
    b.finalize()
    trd.TrajectoryStore.from_flat_dataset(tenvs.FakeImageEnv(
        hw=HW, seed=2).make_dataset(4)).save_cache(str(tmp / "rl"), IMG_ENV)
    _coco(tmp, True, n=4)
    _vqa(tmp, True, n=4)
    return tmp


def _image_cfg(ws, run: str, iters: int):
    cfg = tcfg.db1_tiny(dtype="float32")
    cfg.vision.image_size = HW
    cfg.data.rl_dataset_cache_dir = str(ws / "rl")
    cfg.data.seq_length = cfg.model.n_position
    cfg.data.num_workers = 1
    ic = f"{ws}:{ws / 'captions_True.json'}"
    vqa = f"{ws}:{ws / 'vqa_ann_True.json'}:{ws / 'vqa_q_True.json'}"
    cfg.data.data_path = ("0.25", str(ws / "corpus"), "nlp", "0.25", ic,
                          "ic", "0.25", vqa, "vqa", "0.25", IMG_ENV, "rl")
    t = cfg.train
    t.train_iters, t.global_batch_size, t.micro_batch_size = iters, 16, 8
    t.log_interval, t.eval_interval, t.eval_iters = 1, 3, 1
    t.save_interval, t.save_dir = 2, str(ws / run)
    cfg.eval.ic_vqa_num_samples = 0
    return cfg


def test_pretrain_main_on_an_image_mixture(image_workspace):
    """Two iterations saved, then a resumed run to the third: every batch
    carries the four groups [2, 2, ...] (image RL as ``rl_img<frames>``),
    the losses are finite, the vision tower trains, the resume starts at
    step 3 and the eval hook's valid loss is finite."""
    from bdm_db1_tpu_torch.train import trainer as ttrainer

    ws = image_workspace
    seen, models = [], []
    orig_batch, orig_trainer = ttrainer.to_gato_batch, tpt.Trainer

    def recording(raw, device="cuda"):
        seen.append({m: f["tokens" if "tokens" in f else "text"].shape
                     for m, f in raw.items()})
        return orig_batch(raw, device)

    def keeping(cfg, model, *a, **kw):
        models.append(model)
        return orig_trainer(cfg, model, *a, **kw)

    ttrainer.to_gato_batch, tpt.Trainer = recording, keeping
    try:
        tpt.main(_image_cfg(ws, "run", 2), device="cpu")
        first = models[-1].vision_encoder.patch_embeddings.conv1.weight
        first = first.detach().clone()
        tpt.main(_image_cfg(ws, "run", 3), device="cpu")
    finally:
        ttrainer.to_gato_batch, tpt.Trainer = orig_batch, orig_trainer
    img_key = next(k for k in seen[0] if k.startswith("rl_img"))
    assert img_key == "rl_img11x32x32x3"
    assert seen[0] == {"nlp": (2, 2, 64), "ic": (2, 2, 58),
                       "vqa": (2, 2, 58), img_key: (2, 2, 64)}
    recs = [json.loads(line) for line in
            (ws / "run" / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if "train/loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3]
    assert all(np.isfinite(r["train/loss"]) for r in train)
    valid = [r for r in recs if "valid/loss" in r]
    assert [r["step"] for r in valid] == [3]
    assert np.isfinite(valid[0]["valid/loss"])
    assert (ws / "run" / "2").is_dir() and (ws / "run" / "3").is_dir()
    # the resumed run restored step 2's vision weights and trained them on
    resumed = models[-1].vision_encoder.patch_embeddings.conv1.weight
    assert not torch.equal(resumed, first)


# the mixtures of the refusal cases these replaced: _image_cfg's four
# groups, captions alone, text + VQA (tests/test_torch_pretrain.py)
HOOK_MIXTURES = {
    "four_groups": None,
    "ic": ("1.0", "{ic}", "ic"),
    "nlp_vqa": ("0.5", "{corpus}", "nlp", "0.5", "{vqa}", "vqa"),
}


@pytest.mark.parametrize("mixture", list(HOOK_MIXTURES))
def test_in_training_caption_metrics_match_jax(image_workspace, mixture):
    """``pretrain.main`` at the default ``eval.ic_vqa_num_samples`` (64),
    one step, the eval tick after it: the tick logs ``ic0/*`` for a
    captioning entry and ``vqa0/*`` for a VQA entry, and the trained
    weights through the JAX package's ``evaluate_ic``/``evaluate_vqa`` on
    its own valid split of the same entries (the JAX driver's hook) give
    the same keys and values."""
    from bdm_db1_tpu.core.config import db1_tiny as jdb1_tiny
    from bdm_db1_tpu.eval.evaluate_ic import evaluate_ic as jeval_ic
    from bdm_db1_tpu.eval.evaluate_vqa import evaluate_vqa as jeval_vqa
    from bdm_db1_tpu.models.transformer_xl import TransformerXL as JaxTXL
    from bdm_db1_tpu.tokenizers.text import ByteTextTokenizer as JByte
    from bdm_db1_tpu.train.convert import convert_state_dict

    ws = image_workspace
    cfg = _image_cfg(ws, f"hook_{mixture}", 1)
    cfg.eval.ic_vqa_num_samples = tcfg.EvalConfig().ic_vqa_num_samples
    assert cfg.eval.ic_vqa_num_samples == 64
    cfg.train.eval_interval = 1
    if HOOK_MIXTURES[mixture] is not None:
        parts = dict(ic=cfg.data.data_path[4], vqa=cfg.data.data_path[7],
                     corpus=cfg.data.data_path[1])
        cfg.data.data_path = tuple(x.format(**parts)
                                   for x in HOOK_MIXTURES[mixture])
    models = []
    orig_trainer = tpt.Trainer

    def keeping(cfg, model, *a, **kw):
        models.append(model)
        return orig_trainer(cfg, model, *a, **kw)

    tpt.Trainer = keeping
    try:
        tpt.main(cfg, device="cpu")
    finally:
        tpt.Trainer = orig_trainer
    recs = [json.loads(line) for line in
            (ws / f"hook_{mixture}" / "metrics.jsonl").read_text()
            .splitlines()]
    valid = [r for r in recs if "valid/loss" in r]
    assert [r["step"] for r in valid] == [1]
    got = {k[len("valid/"):]: v for k, v in valid[0].items()
           if k.startswith(("valid/ic", "valid/vqa"))}

    jcfg = jdb1_tiny()
    jcfg.model.dtype = "float32"
    jcfg.vision.image_size = HW
    layout = jcfg.vocab.layout()
    sd = {k: v.detach().numpy() for k, v in models[-1].state_dict().items()}
    sd["word_embedding.weight"] = sd["word_embedding.weight"][
        :layout.total_vocab_size]
    jm = JaxTXL(jcfg.model, jcfg.vocab, jcfg.vision)
    params = convert_state_dict(sd, jcfg)
    jtok = JByte()
    kw = dict(n_position=SEQ, image_size=HW, patch_size=16,
              eos_token_id=jtok.eos_token_id)
    want = {}
    path = cfg.data.data_path
    seen = {"ic": 0, "vqa": 0}
    for prefix, typ in zip(path[1::3], path[2::3]):
        if typ not in seen:
            continue
        make = {"ic": jvit.make_ic_creator, "vqa": jvit.make_vqa_creator}
        ds = make[typ](**kw)(prefix, cfg.data.split, SEQ, (0, 0, 0), 0)[1]
        if typ == "ic":
            metrics = jeval_ic(jm, params, ds, layout, jtok.eos_token_id,
                               num_samples=64, batch_size=8)
        else:
            metrics = jeval_vqa(jm, params, ds, layout, jtok.eos_token_id,
                                text_tokenizer=jtok, num_samples=64,
                                batch_size=8)
        for k, v in metrics.items():
            want[f"{typ}{seen[typ]}/{k}"] = v
        seen[typ] += 1
    assert got == want
    assert any(k.startswith("ic0/") for k in got) == ("ic" in path)
    assert ("vqa0/num_evaluated" in got) == ("vqa" in path)
