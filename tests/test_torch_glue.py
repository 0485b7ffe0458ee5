"""GLUE data on the port against the JAX package: on MNLI-format TSVs and
a WordPiece vocabulary written from a seed (``tests/test_glue_real_data``'s
writer), the tokenizer's tokens and ids, the processor's examples, the
feature arrays and ``GlueDataset``'s arrays (uncached and cached, train
and dev) are equal; so are the synthetic fallback corpus and the
synthetic MLP and image datasets.  The contracts of
``tests/test_dataset_extras.py`` hold for the port's copies, and the
launcher's config reads the same dataset as ``experiment/config.py``
with the GLUE environment unset and set."""

import dataclasses
import os

import numpy as np
import pytest

from skycomputing_tpu.builder import (
    build_dataloader_from_cfg as jax_build_dataloader,
)
from skycomputing_tpu.config import load_config as jax_load_config
from skycomputing_tpu.dataset import GlueDataset as JaxGlue
from skycomputing_tpu.dataset import RandomImageDataset as JaxImages
from skycomputing_tpu.dataset import RandomMlpDataset as JaxMlp
from skycomputing_tpu.dataset import glue as jglue
from skycomputing_tpu_torch.builder import build_dataloader_from_cfg
from skycomputing_tpu_torch.config import load_config
from skycomputing_tpu_torch.dataset import (
    DataLoader,
    GlueDataset,
    RandomImageDataset,
    RandomMlpDataset,
    glue,
)
from skycomputing_tpu_torch.dataset.glue.file_utils import cached_path
from skycomputing_tpu_torch.launch import BatchAdapter
from tests.test_glue_real_data import VOCAB, _write_mnli_dir

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARRAYS = ("input_ids", "input_mask", "segment_ids", "labels")


@pytest.fixture
def mnli(tmp_path):
    return _write_mnli_dir(tmp_path)


def _assert_arrays_equal(got, ref):
    for name in ARRAYS:
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("lower", [False, True])
def test_tokenizer_matches_jax(mnli, lower):
    _, vocab_file = mnli
    got = glue.BertTokenizer(vocab_file=vocab_file, do_lower_case=lower)
    ref = jglue.BertTokenizer(vocab_file=vocab_file, do_lower_case=lower)
    texts = ["The movie was GREAT, truly!", "it was a film truly goodly",
             "bad\tfilm été 中文 ...", "", "unknownword"]
    for text in texts:
        tokens = got.tokenize(text)
        assert tokens == ref.tokenize(text)
        assert got.convert_tokens_to_ids(tokens) == \
            ref.convert_tokens_to_ids(tokens)


@pytest.mark.parametrize("split", ["train", "dev"])
def test_processor_examples_and_features_match_jax(mnli, split):
    data_dir, vocab_file = mnli
    getter = "get_train_examples" if split == "train" else \
        "get_dev_examples"
    got = getattr(glue.PROCESSORS["mnli"](), getter)(data_dir)
    ref = getattr(jglue.PROCESSORS["mnli"](), getter)(data_dir)
    assert [dataclasses.astuple(e) for e in got] == \
        [dataclasses.astuple(e) for e in ref]
    assert len(got) == (96 if split == "train" else 30)
    labels = glue.MnliProcessor().get_labels()
    feats, label_map = glue.convert_examples_to_features(
        got, labels, 24, glue.BertTokenizer(vocab_file=vocab_file))
    ref_feats, ref_map = jglue.convert_examples_to_features(
        ref, labels, 24, jglue.BertTokenizer(vocab_file=vocab_file))
    assert label_map == ref_map
    assert [dataclasses.astuple(f) for f in feats] == \
        [dataclasses.astuple(f) for f in ref_feats]


@pytest.mark.parametrize("split", ["train", "dev"])
def test_glue_dataset_matches_jax_uncached_and_cached(mnli, tmp_path,
                                                      split):
    data_dir, vocab_file = mnli
    kw = dict(data_dir=data_dir, vocab_file=vocab_file, max_seq_length=24,
              processor="mnli", split=split)
    ref = JaxGlue(**kw)
    got = GlueDataset(**kw)
    assert got.synthetic is False and len(got) == len(ref)
    _assert_arrays_equal(got, ref)
    cache = [f for f in os.listdir(data_dir) if f.endswith(".npz")]
    assert cache == [f"mnli_{split}_24_False_vocab.txt.features.npz"]
    cached = GlueDataset(**kw)  # reads the cache file
    _assert_arrays_equal(cached, ref)
    (ids, mask, segs), label = cached[0]
    assert ids[0] == VOCAB.index("[CLS]") and label == ref[0][1]
    # a cache directory of its own
    (tmp_path / "c").mkdir()
    elsewhere = GlueDataset(**kw, cache_dir=str(tmp_path / "c"))
    _assert_arrays_equal(elsewhere, ref)
    assert os.listdir(tmp_path / "c") == cache


def test_glue_dataset_without_a_writable_cache_directory(mnli, tmp_path):
    data_dir, vocab_file = mnli
    missing = str(tmp_path / "no" / "such" / "dir")
    got = GlueDataset(data_dir=data_dir, vocab_file=vocab_file,
                      max_seq_length=24, cache_dir=missing)
    _assert_arrays_equal(got, JaxGlue(data_dir=data_dir,
                                      vocab_file=vocab_file,
                                      max_seq_length=24))


@pytest.mark.parametrize("split,n,seq,processor", [
    ("train", 512, 128, "mnli"), ("dev", 64, 32, "mnli"),
    ("train", 40, 16, "mrpc"), ("dev", 33, 24, "cola"),
])
def test_synthetic_fallback_matches_jax(split, n, seq, processor):
    kw = dict(data_dir="", vocab_file=None, max_seq_length=seq,
              processor=processor, split=split, synthetic_num_samples=n)
    got, ref = GlueDataset(**kw), JaxGlue(**kw)
    assert got.synthetic and ref.synthetic and len(got) == n
    _assert_arrays_equal(got, ref)
    lengths = got.input_mask.sum(1)
    assert lengths.min() >= 8 and lengths.max() <= seq


@pytest.mark.parametrize("cls,ref_cls,kw", [
    (RandomMlpDataset, JaxMlp, dict(num_samples=40, in_features=12,
                                    num_classes=5, seed=3)),
    (RandomImageDataset, JaxImages, dict(num_samples=20, shape=(3, 8, 8),
                                         num_classes=4, seed=1)),
])
def test_synthetic_datasets_match_jax(cls, ref_cls, kw):
    from skycomputing_tpu.dataset import DataLoader as JaxLoader

    got = list(DataLoader(cls(**kw), batch_size=8, shuffle=True, seed=2))
    ref = list(JaxLoader(ref_cls(**kw), batch_size=8, shuffle=True, seed=2))
    assert len(got) == len(ref) == kw["num_samples"] // 8
    for (data, labels), (rdata, rlabels) in zip(got, ref):
        np.testing.assert_array_equal(data[0], rdata[0])
        np.testing.assert_array_equal(labels, rlabels)


# --- the contracts of tests/test_dataset_extras.py, on the port's copies --

def test_cached_path_local_and_data_home(tmp_path, monkeypatch):
    f = tmp_path / "vocab.txt"
    f.write_text("[PAD]\n[UNK]\n")
    assert cached_path(str(f)) == str(f)
    monkeypatch.setenv("SKYTPU_DATA_HOME", str(tmp_path))
    assert cached_path("vocab.txt") == str(tmp_path / "vocab.txt")
    with pytest.raises(FileNotFoundError, match="missing.txt"):
        cached_path("missing.txt")


def test_cached_path_rejects_urls():
    with pytest.raises(OSError, match="no network egress"):
        cached_path("https://example.com/vocab.txt")
    with pytest.raises(OSError, match="no network egress"):
        cached_path("s3://bucket/vocab.txt")


def test_tokenizer_wordpiece_greedy():
    vocab = {t: i for i, t in enumerate(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "un", "##aff", "##able",
         "hello", "world", "!"])}
    tok = glue.BertTokenizer(vocab=vocab, do_lower_case=True)
    assert tok.tokenize("unaffable") == ["un", "##aff", "##able"]
    assert tok.tokenize("Hello, world!") == ["hello", "[UNK]", "world", "!"]
    assert tok.convert_tokens_to_ids(["hello", "nope"]) == [7, 1]


def test_synthetic_vocab_matches_jax():
    assert glue.build_synthetic_vocab(256) == glue.build_synthetic_vocab(256)
    assert glue.build_synthetic_vocab() == jglue.build_synthetic_vocab()


def test_train_wordpiece_vocab_matches_jax_and_roundtrips():
    corpus = [
        "the quick brown fox jumps over the lazy dog",
        "the quick brown cat sleeps under the lazy tree",
        "quick foxes and quick cats are quick",
    ] * 5
    vocab = glue.train_wordpiece_vocab(corpus, vocab_size=200,
                                       min_frequency=2)
    assert vocab == jglue.train_wordpiece_vocab(corpus, vocab_size=200,
                                                min_frequency=2)
    assert "[UNK]" in vocab and "[CLS]" in vocab and "quick" in vocab
    tok = glue.BertTokenizer(vocab=vocab, do_lower_case=True)
    pieces = tok.tokenize("the quick brown fox")
    assert "[UNK]" not in pieces
    rebuilt = "".join(p[2:] if p.startswith("##") else " " + p
                      for p in pieces).strip()
    assert rebuilt == "the quick brown fox"
    assert tok.tokenize("Ω") == ["[UNK]"]


# --- the launcher's config reads experiment/config.py's dataset ----------

@pytest.mark.parametrize("glue_env", [False, True], ids=["unset", "set"])
def test_launcher_config_dataset_matches_experiment_config(
        monkeypatch, tmp_path, glue_env):
    for key in ("SKYTPU_GLUE_DIR", "SKYTPU_VOCAB_FILE", "SKYTPU_MODEL"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("SKYTPU_PRESET", "tiny")
    monkeypatch.setenv("SKYTPU_SEQ_LEN", "24")
    monkeypatch.setenv("SKYTPU_BATCH_SIZE", "8")
    monkeypatch.setenv("SKYTPU_LOG_ROOT", str(tmp_path / "logs"))
    if glue_env:
        data_dir, vocab_file = _write_mnli_dir(tmp_path)
        monkeypatch.setenv("SKYTPU_GLUE_DIR", data_dir)
        monkeypatch.setenv("SKYTPU_VOCAB_FILE", vocab_file)
    monkeypatch.chdir(ROOT)
    cfg = load_config("skycomputing_tpu_torch/configs/bert_pipeline.py")
    ref_cfg = jax_load_config("experiment/config.py")
    assert cfg.data_config == ref_cfg.data_config
    got = build_dataloader_from_cfg(cfg.data_config)
    ref = jax_build_dataloader(ref_cfg.data_config)
    assert got.dataset.synthetic is ref.dataset.synthetic is (not glue_env)
    _assert_arrays_equal(got.dataset, ref.dataset)
    batches = list(zip(range(3), BatchAdapter(got), ref))
    assert len(batches) == 3
    for _, (data, labels), ((ids, mask, segs), ref_labels) in batches:
        # the launcher's reorder: (ids, token types, mask)
        for a, b in zip(data, (ids, segs, mask)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(labels, ref_labels)
