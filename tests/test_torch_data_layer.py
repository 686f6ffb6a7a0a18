"""The port's data layer against the JAX package's, on the CPU and without
jit: indexed corpora written byte-equal and read both ways, the four index
builders, the GPT maps and samples, blending in both modes, the seeded
dataset wrapper and the prefetch loader, the dataset factory with the
stratified loader of the pretraining driver, the text tokenizer and codec,
and the preprocessing tool."""

import ctypes
import json
import os
import subprocess
from fractions import Fraction

import numpy as np
import pytest

from bdm_db1_tpu.data import blendable as jbl
from bdm_db1_tpu.data import dataset_utils as jdu
from bdm_db1_tpu.data import gpt_dataset as jgpt
from bdm_db1_tpu.data import indexed_dataset as jix
from bdm_db1_tpu.data import native as jnat
from bdm_db1_tpu.data import preprocess as jpre
from bdm_db1_tpu.data import rl_dataset as jrl
from bdm_db1_tpu.data import samplers as jsam
from bdm_db1_tpu.data import text_codec as jcodec
from bdm_db1_tpu.tokenizers import text as jtext
from bdm_db1_tpu_torch.data import blendable as tbl
from bdm_db1_tpu_torch.data import dataset_utils as tdu
from bdm_db1_tpu_torch.data import gpt_dataset as tgpt
from bdm_db1_tpu_torch.data import indexed_dataset as tix
from bdm_db1_tpu_torch.data import native as tnat
from bdm_db1_tpu_torch.data import preprocess as tpre
from bdm_db1_tpu_torch.data import rl_dataset as trl
from bdm_db1_tpu_torch.data import samplers as tsam
from bdm_db1_tpu_torch.data import text_codec as tcodec
from bdm_db1_tpu_torch.tokenizers import text as ttext


@pytest.fixture(scope="module", autouse=True)
def _jax_native_helpers(tmp_path_factory):
    """The JAX package's index helpers are its C++ library, built on first
    use inside the package (g++ -O3 -march=native). A process whose load
    raced another process's build falls back to numpy for good, and that
    fallback rounds weight * (i + 1) before the subtraction in
    build_blending_indices where the library's fused multiply-add does not.
    In that case build the library here from the JAX source with the JAX
    package's command, so every comparison runs against its native path."""
    if jnat._load_native() is not None:
        return
    out = tmp_path_factory.mktemp("native") / "libdb1helpers.so"
    subprocess.run(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
         os.path.join(jnat._NATIVE_DIR, "helpers.cpp"), "-o", str(out)],
        check=True, capture_output=True, timeout=120)
    jnat._lib = ctypes.CDLL(str(out))


def _docs(seed, n=12, vocab=1000):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=rng.randint(0, 40)) for _ in range(n)]


def _write(mod, prefix, impl, docs, vocab=1000):
    """Every item its own document, then a shard merged in."""
    shard = prefix + "_shard"
    b = mod.make_builder(shard, impl=impl, vocab_size=vocab)
    for d in docs[:3]:
        b.add_document(d)
    b.finalize()
    b = mod.make_builder(prefix, impl=impl, vocab_size=vocab)
    for d in docs[3:]:
        b.add_item(d)
        b.end_document()
    b.merge_file_(shard)
    b.finalize()
    return prefix


def _bytes(prefix):
    return [open(prefix + ext, "rb").read() for ext in (".idx", ".bin")]


# ---- indexed corpora ---------------------------------------------------------

@pytest.mark.parametrize("impl,vocab", [("mmap", 1000), ("mmap", 70000),
                                        ("lazy", 1000)])
def test_indexed_files_byte_equal(tmp_path, impl, vocab):
    """The port's builder writes the JAX builder's bytes (uint16 below a
    vocab of 65500, int32 above; merge_file_ included)."""
    docs = _docs(0, vocab=vocab)
    j = _write(jix, str(tmp_path / "j"), impl, docs, vocab)
    t = _write(tix, str(tmp_path / "t"), impl, docs, vocab)
    assert _bytes(t) == _bytes(j)


@pytest.mark.parametrize("impl", ["mmap", "lazy", "cached"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_files(tmp_path, impl, writer):
    docs = _docs(1)
    w_mod = jix if writer == "jax" else tix
    prefix = _write(w_mod, str(tmp_path / "c"), "mmap" if impl == "mmap"
                    else "lazy", docs)
    order = docs[3:] + docs[:3]
    readers = [mod.make_dataset(prefix, impl=impl) for mod in (jix, tix)]
    for r in readers:
        assert len(r) == len(order)
        np.testing.assert_array_equal(r.doc_idx, np.arange(len(order) + 1))
        if impl == "cached":
            r.prefetch([0, 4])
        for i, d in enumerate(order):
            np.testing.assert_array_equal(r[i], d)
            assert r[i].dtype == np.uint16
    np.testing.assert_array_equal(readers[0].sizes, readers[1].sizes)
    if impl == "mmap":
        for r in readers:
            np.testing.assert_array_equal(r.get(1, offset=2, length=5),
                                          order[1][2:7])


def test_legacy_reader_rejects_a_shifted_index(tmp_path):
    prefix = _write(tix, str(tmp_path / "c"), "lazy", _docs(2))
    with open(prefix + ".idx", "ab") as f:
        f.write(b"\0" * 8)
    for mod in (jix, tix):
        with pytest.raises(ValueError, match="doc_idx"):
            mod.IndexedDataset(prefix)


# ---- index builders ----------------------------------------------------------

def _sizes_and_doc_idx(seed, n_docs, epochs):
    rng = np.random.RandomState(seed)
    sizes = rng.randint(0, 50, size=n_docs).astype(np.int32)
    sizes[::7] = 0                       # empty documents hold no token
    doc_idx = np.concatenate([rng.permutation(n_docs) for _ in range(epochs)])
    return sizes, doc_idx


@pytest.mark.parametrize("seed,n_docs,epochs,seq", [
    (0, 30, 1, 16), (1, 30, 3, 16), (2, 50, 2, 7), (3, 9, 4, 64),
    (4, 40, 1, 1)])
def test_build_sample_idx_equals_jax(seed, n_docs, epochs, seq):
    sizes, doc_idx = _sizes_and_doc_idx(seed, n_docs, epochs)
    tokens = int(sizes.sum())
    got = tnat.build_sample_idx(sizes, doc_idx, seq, epochs, tokens)
    want = jnat.build_sample_idx(sizes, doc_idx, seq, epochs, tokens)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("weights,size", [
    ([0.5, 0.5], 101), ([0.7, 0.2, 0.1], 500), ([1 / 3] * 3, 64),
    ([0.999, 0.001], 50)])
def test_build_blending_indices_equals_jax(weights, size):
    """The C index (csrc/blending.c) equal to its plain Python version, to
    the JAX helper library's and to an exact-rational reference of its
    once-rounded errors (0.7 / 0.2 / 0.1 holds the tie at i = 4)."""
    got = tnat.build_blending_indices(np.asarray(weights), size)
    want = jnat.build_blending_indices(np.asarray(weights), size)
    plain = tnat.build_blending_indices_plain(np.asarray(weights), size)
    for g, w, p in zip(got, want, plain):
        assert g.dtype == w.dtype == p.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)
    exact = [Fraction(w) for w in np.asarray(weights, np.float64)]
    counts = [0] * len(exact)
    for i in range(size):
        errs = [float(w * (i + 1) - c) for w, c in zip(exact, counts)]
        j = int(np.argmax(errs))
        assert (got[0][i], got[1][i]) == (j, counts[j])
        counts[j] += 1


def test_blending_index_build_failure_raises(tmp_path, monkeypatch):
    """A source the compiler refuses raises with the compiler's output;
    nothing falls back to the Python loop."""
    bad = tmp_path / "blending.c"
    bad.write_text("int bdm_build_blending_indices(void) { return }\n")
    monkeypatch.setattr(tnat, "_BLEND_SRC", bad)
    monkeypatch.setattr(tnat, "_NATIVE_BUILD", tmp_path / "build")
    tnat._blend_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="blending.c failed"):
            tnat.build_blending_indices(np.asarray([0.5, 0.5]), 4)
    finally:
        tnat._blend_lib.cache_clear()
    assert not list((tmp_path / "build").glob("*.so"))


def _mapping_corpus(seed=0, n_docs=40):
    """Empty, one-sentence, long-sentence (> 512) and multi-sentence docs."""
    rng = np.random.RandomState(seed)
    sizes, docs = [], [0]
    for d in range(n_docs):
        kind = d % 5
        n_sent = 0 if kind == 0 else 1 if kind == 1 else rng.randint(2, 8)
        for _ in range(n_sent):
            sizes.append(int(rng.randint(3, 40)))
        if kind == 4 and n_sent:
            sizes[-1] = 600
        docs.append(len(sizes))
    return np.asarray(docs, np.int64), np.asarray(sizes, np.int32)


@pytest.mark.parametrize("min_num_sent,short_prob", [(2, 0.1), (1, 0.0)])
def test_build_mapping_equals_jax(min_num_sent, short_prob):
    docs, sizes = _mapping_corpus()
    for epochs, cap in [(1, 10**9), (3, 25)]:
        got = tnat.build_mapping(docs, sizes, epochs, cap, 64, short_prob,
                                 1234, min_num_sent)
        want = jnat.build_mapping(docs, sizes, epochs, cap, 64, short_prob,
                                  1234, min_num_sent)
        assert len(got) > 0
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("one_sent", [False, True])
def test_build_blocks_mapping_equals_jax(one_sent):
    docs, sizes = _mapping_corpus(seed=3)
    titles = np.arange(len(docs) - 1, dtype=np.int32) % 7
    for epochs, cap in [(2, 10**9), (2, 13)]:
        got = tnat.build_blocks_mapping(docs, sizes, titles, epochs, cap, 64,
                                        99, one_sent)
        want = jnat.build_blocks_mapping(docs, sizes, titles, epochs, cap,
                                         64, 99, one_sent)
        assert len(got) > 0
        np.testing.assert_array_equal(got, want)


def test_mt19937_draws_are_the_standard_ones():
    """The 10000th draw of a default-seeded (5489) generator is the C++
    standard's check value for each engine."""
    for gen, want in ((tnat._MT19937(5489), 4123659995),
                      (tnat._MT19937_64(5489), 9981545732273789042)):
        for _ in range(9999):
            gen()
        assert gen() == want


# ---- GPT dataset -------------------------------------------------------------

def _corpus(tmp_path, mod, name="corpus", n=40, seed=5):
    prefix = str(tmp_path / name)
    b = mod.make_builder(prefix, vocab_size=256)
    rng = np.random.RandomState(seed)
    for _ in range(n):
        b.add_document(rng.randint(1, 250, size=rng.randint(5, 80)))
    b.finalize()
    return prefix


@pytest.mark.parametrize("num_samples,seq", [
    (20, 32),      # one epoch
    (150, 32),     # 3 epochs, the last one short: shuffled on its own
    (110, 40),     # 2 epochs, the last one long: shuffled with the rest
])
def test_gpt_dataset_maps_and_samples_equal_jax(tmp_path, num_samples, seq):
    prefix = _corpus(tmp_path, jix)
    docs = np.arange(0, 30, dtype=np.int32)
    ds = {}
    for name, mod, imod in (("jax", jgpt, jix), ("port", tgpt, tix)):
        cache = str(tmp_path / f"maps_{name}")
        ds[name] = mod.GPTDataset("train", imod.make_dataset(prefix), docs,
                                  num_samples, seq, seed=7, cache_dir=cache)
    j, t = ds["jax"], ds["port"]
    for a, b in ((t.doc_idx, j.doc_idx), (t.sample_idx, j.sample_idx),
                 (t.shuffle_idx, j.shuffle_idx)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(t) == len(j) >= num_samples
    for i in range(50):
        a, b = t[i], j[i]
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    # the cached maps read back (mmap); the port's files are the JAX
    # package's names with the corpus key after the split name
    again = tgpt.GPTDataset("train", tix.make_dataset(prefix), docs,
                            num_samples, seq, seed=7,
                            cache_dir=str(tmp_path / "maps_port"))
    assert isinstance(again.sample_idx, np.memmap)
    for a, b in ((again.doc_idx, j.doc_idx), (again.sample_idx, j.sample_idx),
                 (again.shuffle_idx, j.shuffle_idx)):
        np.testing.assert_array_equal(a, b)
    key = tgpt._maps_key(t.indexed.sizes, docs)
    names = sorted(os.listdir(tmp_path / "maps_port"))
    assert names == sorted(n.replace("train_", f"train_{key}_", 1)
                           for n in os.listdir(tmp_path / "maps_jax"))


@pytest.mark.parametrize("via", ["dataset", "factory"])
def test_gpt_maps_of_two_corpora_in_one_cache_dir(tmp_path, via):
    """Two corpora, one cache directory, the same split name: each reads
    its own maps, equal to the JAX package's built without a cache (the
    JAX package, sharing the directory, hands the second corpus the
    first's maps; ROADMAP queue 3)."""
    a = _corpus(tmp_path, tix, name="a", n=40, seed=5)
    b = _corpus(tmp_path, tix, name="b", n=25, seed=6)
    cache = str(tmp_path / "maps")
    if via == "dataset":
        def build(mod, ix, prefix, cache_dir):
            n = len(ix.make_dataset(prefix).sizes)
            return mod.GPTDataset("train", ix.make_dataset(prefix),
                                  np.arange(n, dtype=np.int32), 60, 32,
                                  seed=7, cache_dir=cache_dir)

        got = [build(tgpt, tix, p, cache) for p in (a, b)]
        again = [build(tgpt, tix, p, cache) for p in (a, b)]
        want = [build(jgpt, jix, p, None) for p in (a, b)]
    else:
        def build(du, cache_dir):
            train = du.build_train_valid_test_datasets(
                ["0.5", a, "nlp", "0.5", b, "nlp"], "100,0,0", 32,
                (60, 0, 0), seed=7, global_batch_size=8,
                cache_dir=cache_dir)[0]
            return [part.ds for part in train.datasets]

        got, again, want = build(tdu, cache), build(tdu, cache), \
            build(jdu, None)
    assert len(os.listdir(cache)) == 6
    for g, r, w in zip(got, again, want):
        assert isinstance(r.sample_idx, np.memmap)
        for k in ("doc_idx", "sample_idx", "shuffle_idx"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k))
            np.testing.assert_array_equal(getattr(r, k), getattr(w, k))
        for i in range(len(w)):
            np.testing.assert_array_equal(r[i]["tokens"], w[i]["tokens"])


@pytest.mark.parametrize("flags", [(False, False, False), (True, True, True),
                                   (True, False, True)])
def test_ltor_masks_equal_jax(flags):
    tokens = np.random.RandomState(0).randint(0, 5, size=(3, 17))
    got = tgpt.get_ltor_masks_and_position_ids(tokens, 0, *flags)
    want = jgpt.get_ltor_masks_and_position_ids(tokens, 0, *flags)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)


# ---- mixtures and samplers ---------------------------------------------------

class _Items:
    def __init__(self, tag, n):
        self.tag, self.n = tag, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"tokens": np.full(3, 100 * self.tag + i)}


@pytest.mark.parametrize("mode", ["slot", "index"])
def test_blendable_equals_jax(mode):
    seqs = []
    for mod in (jbl, tbl):
        ds = mod.BlendableDataset([_Items(0, 7), _Items(1, 13), _Items(2, 4)],
                                  [0.5, 0.3, 0.2], global_batch_size=8,
                                  mode=mode, seed=3)
        assert len(ds) == 24
        seqs.append([int(ds[i]["tokens"][0]) for i in range(60)])
    assert seqs[0] == seqs[1]


def test_random_seed_dataset_and_prefetch_loader_equal_jax():
    class Noisy:
        def __len__(self):
            return 20

        def __getitem__(self, i):
            return {"x": np.random.rand(4) + i, "y": np.full(2, i),
                    "modality": "rl"}

    out = []
    for mod in (jsam, tsam):
        ds = mod.RandomSeedDataset(Noisy(), base_seed=11)
        ds.set_epoch(2)
        loader = mod.PrefetchLoader(
            ds, mod.RandomSampler(20, 0, 3, 0, 1, seed=4), accum_steps=2,
            num_threads=1)
        out.append([next(loader) for _ in range(4)])
        loader.stop()
    for bj, bt in zip(*out):
        assert bj.keys() == bt.keys() == {"x", "y"}
        for k in bj:
            assert bt[k].shape == (2, 3) + bj[k].shape[2:]
            np.testing.assert_array_equal(bt[k], bj[k])


# ---- factory and loader ------------------------------------------------------

def _rl_cache(tmp_path, env_name, seed=0, episodes=6):
    from bdm_db1_tpu_torch.eval.envs import FakeContinuousEnv

    env = FakeContinuousEnv(obs_dim=4, act_dim=2, episode_len=9, seed=seed)
    trl.TrajectoryStore.from_flat_dataset(env.make_dataset(episodes)) \
        .save_cache(str(tmp_path), env_name)


def _suites():
    from bdm_db1_tpu.core.config import db1_tiny as jtiny
    from bdm_db1_tpu.tokenizers.scalar import ScalarTokenizer as JScalar
    from bdm_db1_tpu_torch.core.config import db1_tiny as ttiny
    from bdm_db1_tpu_torch.tokenizers.scalar import ScalarTokenizer as TScalar

    jc, tc = jtiny(), ttiny()
    return (jrl.RLTokenizerSuite(
                jc.vocab.layout(), JScalar(jc.vocab.num_continuous_bin),
                jtext.ByteTextTokenizer(), vision_patch_size=16),
            trl.RLTokenizerSuite(
                tc.vocab.layout(), TScalar(tc.vocab.num_continuous_bin),
                ttext.ByteTextTokenizer(), vision_patch_size=16))


def _factory(tmp_path, which, fewshot=None):
    """The JAX or the port pipeline: rl creators registered, the factory
    on a 0.5 nlp / 0.3 rl / 0.2 rl_task_suite path, each package with its
    own copies of the corpus and the caches."""
    mods = {"jax": (jdu, jrl, jix), "port": (tdu, trl, tix)}[which]
    du, rl, ix = mods
    root = tmp_path / which
    for name, seed in (("fake-a", 0), ("fake-b", 1)):
        _rl_cache(root / "rl", name, seed)
    prefix = _corpus(root, ix, n=30)
    suite = _suites()[0 if which == "jax" else 1]
    rl_c, suite_c = rl.make_rl_creator(
        suite, str(root / "rl"), suite_envs=lambda s: ["fake-a", "fake-b"],
        num_fewshot_episodes=fewshot, use_prompt=True)
    du.register_creator("rl", rl_c)
    du.register_creator("rl_task_suite", suite_c)
    return du.build_train_valid_test_datasets(
        ["0.5", prefix, "nlp", "0.3", "fake-a", "rl",
         "0.2", "fake-suite", "rl_task_suite"],
        "80,10,10", 64, (48, 8, 0), seed=3, global_batch_size=8,
        cache_dir=str(root / "maps"))


def test_factory_and_loader_batches_equal_jax(tmp_path):
    """build_train_valid_test_datasets -> group_by_modality -> build_loader
    (one thread): the first 3 batches are bitwise the JAX pipeline's."""
    from bdm_db1_tpu.core.config import db1_tiny as jtiny
    from bdm_db1_tpu.train import pretrain as jpt
    from bdm_db1_tpu_torch.core.config import db1_tiny as ttiny
    from bdm_db1_tpu_torch.train import pretrain as tpt

    out = {}
    for which, pt, tiny in (("jax", jpt, jtiny), ("port", tpt, ttiny)):
        train, _, _, no_blend = _factory(tmp_path, which)
        assert set(no_blend) == {"nlp", "rl", "rl_task_suite"}
        cfg = tiny()
        cfg.train.micro_batch_size = 4
        cfg.train.global_batch_size = 8
        cfg.data.num_workers = 1
        groups, weights = pt.group_by_modality(train)
        assert set(groups) == {"nlp", "rl"}
        assert weights == pytest.approx({"nlp": 0.5, "rl": 0.5})
        loader = (pt.build_loader(cfg, groups, weights, 1) if which == "jax"
                  else pt.build_loader(cfg, groups, weights))
        out[which] = [next(loader) for _ in range(3)]
        loader.stop()
    for bj, bt in zip(out["jax"], out["port"]):
        assert bj.keys() == bt.keys() == {"nlp", "rl"}
        for m in bj:
            assert bj[m].keys() == bt[m].keys()
            assert bt[m]["tokens"].shape == (2, 2, 64)
            for k in bj[m]:
                assert bt[m][k].dtype == bj[m][k].dtype, (m, k)
                np.testing.assert_array_equal(bt[m][k], bj[m][k])


def test_fewshot_creator_equals_jax(tmp_path):
    """num_fewshot_episodes: the train split draws from the first N
    trajectories (9 steps each); valid keeps the full split."""
    got = {}
    for which in ("jax", "port"):
        root = tmp_path / which
        _rl_cache(root, "fake-a")
        suite = _suites()[0 if which == "jax" else 1]
        rl = jrl if which == "jax" else trl
        rl_c, _ = rl.make_rl_creator(suite, str(root),
                                     num_fewshot_episodes=2, use_prompt=False)
        got[which] = rl_c("fake-a", "80,10,10", 64, None, 0)
    (jtr, jva, _), (ttr, tva, _) = got["jax"], got["port"]
    assert isinstance(ttr, trl.RLFinetuneDataset) and len(ttr) == 18
    assert len(tva) == len(jva)
    for a, b in ((ttr, jtr), (tva, jva)):
        for i in range(len(b)):
            x, y = a[i], b[i]
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])


def test_weights_types_and_errors():
    path = ["2", "a", "nlp", "6", "b", "rl"]
    assert tdu.get_datasets_weights_and_types(path) == \
        jdu.get_datasets_weights_and_types(path)
    with pytest.raises(ValueError, match="weight prefix type"):
        tdu.get_datasets_weights_and_types(["1", "a"])
    with pytest.raises(ValueError, match="unknown dataset type"):
        tdu.build_train_valid_test_datasets(["1", "a", "nope"], "1", 8,
                                            (1, 0, 0), 0, 1)


# ---- text --------------------------------------------------------------------

TEXTS = ["Hello world. How are you? Fine!", "héllo — ünïcode.\nLine two.",
         "", "no punctuation at all"]


def test_byte_tokenizer_equals_jax_and_round_trips():
    j, t = jtext.ByteTextTokenizer(300), ttext.ByteTextTokenizer(300)
    for s in TEXTS:
        assert t.encode(s) == j.encode(s)
        assert t.decode(t.encode(s)) == s
    for kw in ({}, {"padding": "max_length", "truncation": True,
                    "max_length": 8}):
        assert t(TEXTS, **kw) == j(TEXTS, **kw)
        assert t(TEXTS[0], **kw) == j(TEXTS[0], **kw)
    with pytest.raises(ValueError):
        ttext.ByteTextTokenizer(100)


def test_build_text_tokenizer_falls_back_to_bytes(tmp_path, monkeypatch):
    monkeypatch.setenv("DB1_TOKENIZER_PATH", str(tmp_path / "missing"))
    for mod in (jtext, ttext):
        tok = mod.build_text_tokenizer(None, 32000)
        assert type(tok).__name__ == "ByteTextTokenizer"
        assert tok.vocab_size == 32000 and tok.eos_token_id == 0
    assert ttext.build_text_tokenizer(None, 10).vocab_size == 257


def test_encoder_and_decoder_equal_jax():
    j, t = jtext.ByteTextTokenizer(), ttext.ByteTextTokenizer()
    for split in (True, False):
        je = jcodec.Encoder(j, split_into_sentences=split)
        te = tcodec.Encoder(t, split_into_sentences=split)
        for s in TEXTS:
            assert te.encode(s) == je.encode(s)
            assert te.encode_flat(s) == je.encode_flat(s)
    assert tcodec.split_sentences(TEXTS[0]) == jcodec.split_sentences(TEXTS[0])
    ids = t.encode("abc def") + [0] + t.encode("ghi")
    for n in (3, 30):
        assert tcodec.Decoder(t, n).decode(ids) == \
            jcodec.Decoder(j, n).decode(ids)


def _jsonl(tmp_path, n=60):
    rng = np.random.RandomState(0)
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
    path = tmp_path / "docs.jsonl"
    with open(path, "w") as f:
        for i in range(n):
            sents = [" ".join(rng.choice(words, rng.randint(2, 9))).capitalize()
                     + "." for _ in range(rng.randint(1, 5))]
            f.write(json.dumps({"text": " ".join(sents), "id": i}) + "\n")
        f.write("not json\n\n")
    return str(path)


@pytest.mark.parametrize("impl,workers,split", [
    ("mmap", 1, True), ("lazy", 1, True),
    # a pool of 2 spawned workers (no sentence split: a child would import
    # nltk, seconds each)
    ("mmap", 2, False)])
def test_preprocess_writes_the_jax_tools_bytes(tmp_path, impl, workers,
                                               split):
    src = _jsonl(tmp_path)
    common = ["--input", src, "--json-key", "text", "--dataset-impl", impl]
    if not split:
        common.append("--no-sentence-split")
    jpre.main(common + ["--output-prefix", str(tmp_path / "j")])
    stats = tpre.main(common + ["--output-prefix", str(tmp_path / "t"),
                                "--workers", str(workers)])
    assert _bytes(str(tmp_path / "t")) == _bytes(str(tmp_path / "j"))
    ds = tix.make_dataset(str(tmp_path / "t"), impl=impl)
    assert stats["docs"] == len(ds) == 60
    assert stats["tokens"] == int(np.sum(ds.sizes))
