"""Data-layer tests: tokenizer, vocabulary, COCO loading, cluster vectors,
batching — the semantics the reference pins down in
utils/captions.py / utils/batch_gen.py."""

import os

import numpy as np
import pytest

from vae_captioning.config import Config
from vae_captioning.data import cluster_vectors as cv_lib
from vae_captioning.data.batcher import CaptionBatcher, bucket_length, repartition
from vae_captioning.data.coco import CocoCaptions, coco_paths
from vae_captioning.data.tokenizer import detokenize, tokenize_caption
from vae_captioning.data.vocabulary import Vocabulary


# ---------------------------------------------------------------- tokenizer

def test_tokenize_matches_reference_scheme():
    # ref utils/captions.py:38-41 — lowercase, \W+ split, BOS/EOS wrap
    assert tokenize_caption("A man, riding a horse!") == [
        "<BOS>", "a", "man", "riding", "a", "horse", "<EOS>"]
    assert tokenize_caption("  Hello---world  ") == [
        "<BOS>", "hello", "world", "<EOS>"]
    assert tokenize_caption("") == ["<BOS>", "<EOS>"]


def test_detokenize_drops_control_tokens():
    assert detokenize(["<BOS>", "a", "dog", "<EOS>"]) == "a dog"


# ---------------------------------------------------------------- vocabulary

def test_vocab_id_assignment():
    caps = [tokenize_caption("a dog runs"), tokenize_caption("a dog sits"),
            tokenize_caption("a cat sits")]
    vocab = Vocabulary.build(caps, keep_words=2)
    # counts: a=3, dog=2, sits=2, BOS=3, EOS=3, cat=1(dropped), runs=1(dropped)
    assert vocab.pad_id == 0
    assert vocab.word2idx["<PAD>"] == 0
    # sorted by (-count, word): <BOS>=3, <EOS>=3, a=3 → alphabetical tie-break
    assert vocab.decode([1, 2, 3]) == ["<BOS>", "<EOS>", "a"]
    assert "cat" not in vocab
    assert "<UNK>" in vocab  # kept despite low count
    assert vocab.encode(["cat"]) == [vocab.unk_id]


def test_vocab_roundtrip(tmp_path):
    caps = [tokenize_caption("a dog runs fast")] * 3
    vocab = Vocabulary.build(caps, keep_words=2)
    path = str(tmp_path / "vocab.json")
    vocab.save(path)
    loaded = Vocabulary.load(path)
    assert loaded.word2idx == vocab.word2idx
    assert loaded.vocab_size == vocab.vocab_size


def test_vocab_min_count_filter():
    caps = [tokenize_caption("common word"), tokenize_caption("common thing")]
    vocab = Vocabulary.build(caps, keep_words=2)
    assert "common" in vocab
    assert "word" not in vocab and "thing" not in vocab


# ---------------------------------------------------------------- coco load

def test_coco_captions_load(mini_coco):
    paths = coco_paths(mini_coco)
    caps = CocoCaptions(paths["train_cap_json"])
    assert caps.num_images == 10
    for fn, cap_list in caps.captions.items():
        assert len(cap_list) == 5
        for cap in cap_list:
            assert cap[0] == "<BOS>" and cap[-1] == "<EOS>"
    # filename <-> id maps agree
    for fn, imid in caps.filename_to_imid.items():
        assert caps.imid_to_filename[imid] == fn


def test_coco_index_captions(mini_coco):
    paths = coco_paths(mini_coco)
    caps = CocoCaptions(paths["train_cap_json"])
    vocab = Vocabulary.build(caps.all_tokenized(), keep_words=1)
    caps.index_captions(vocab)
    fn = next(iter(caps.captions_indexed))
    ids = caps.captions_indexed[fn][0]
    assert vocab.decode(ids) == caps.captions[fn][0]


# ---------------------------------------------------------------- c_v

def test_cluster_vectors_from_instances(mini_coco):
    paths = coco_paths(mini_coco)
    vecs = cv_lib.build_from_instances(paths["train_instances_json"])
    assert len(vecs) == 10
    for v in vecs.values():
        assert v.shape == (91,)
        assert v.sum() == pytest.approx(1.0) or v.sum() == 0.0
        active = v[v > 0]
        if len(active):
            assert np.allclose(active, active[0])  # uniform over detected


def test_cluster_vectors_roundtrip(tmp_path, mini_coco):
    paths = coco_paths(mini_coco)
    vecs = cv_lib.build_from_instances(paths["train_instances_json"])
    npz = str(tmp_path / "c_v.npz")
    cv_lib.save(vecs, npz)
    loaded = cv_lib.load(npz)
    for k in vecs:
        np.testing.assert_allclose(loaded[k], vecs[k])
    # reference pickle format too
    pkl = str(tmp_path / "c_v.pickle")
    cv_lib.save(vecs, pkl)
    loaded_pkl = cv_lib.load(pkl)
    for k in vecs:
        np.testing.assert_allclose(loaded_pkl[k], vecs[k])


def test_cluster_lookup_zero_fallback():
    out, n_fallbacks = cv_lib.lookup_batch(
        {"a.jpg": np.ones(91, np.float32)}, ["a.jpg", "missing.jpg"])
    assert out.shape == (2, 91)
    assert out[1].sum() == 0.0  # ref utils/batch_gen.py:113-118
    assert n_fallbacks == 1


def test_cluster_vectors_from_detections():
    vecs = cv_lib.build_from_detections(
        [("x.jpg", [(3, 0.9), (7, 0.6), (9, 0.2)])], score_threshold=0.5)
    v = vecs["x.jpg"]
    assert v[3] == pytest.approx(0.5) and v[7] == pytest.approx(0.5)
    assert v[9] == 0.0


# ---------------------------------------------------------------- batching

def _make_batcher(mini_coco, batch_size=4, **kw):
    paths = coco_paths(mini_coco)
    caps = CocoCaptions(paths["train_cap_json"])
    vocab = Vocabulary.build(caps.all_tokenized(), keep_words=1)
    caps.index_captions(vocab)
    from glob import glob
    files = sorted(glob(os.path.join(paths["train_dir"], "*.jpg")))

    class FakeFeatures:
        def get_batch(self, fns):
            return np.stack([np.full(4096, hash(os.path.basename(f)) % 7,
                                     dtype=np.float32) for f in fns])

    return CaptionBatcher(files, caps.captions_indexed, batch_size,
                          feature_store=FakeFeatures(), **kw), vocab


def test_bucket_length():
    assert bucket_length(1, 8) == 8
    assert bucket_length(8, 8) == 8
    assert bucket_length(9, 8) == 16
    assert bucket_length(30, 8, cap=24) == 24


def test_train_batch_shapes(mini_coco):
    batcher, vocab = _make_batcher(mini_coco, batch_size=4)
    batches = list(batcher.train_batches(num_captions=1))
    assert len(batches) == 2  # 10 images, drop remainder
    b = batches[0]
    assert b.features.shape == (4, 4096)
    assert b.dec_inputs.shape[0] == 4 and b.dec_inputs.shape[1] == 1
    assert b.dec_inputs.shape[2] % 8 == 0  # bucketed
    assert b.cluster_vectors.shape == (4, 90)
    assert b.valid == 4


def test_caption_split_semantics(mini_coco):
    # dec_inputs = cap[:-1] (<BOS>…), labels = cap[1:] (…<EOS>),
    # length = len(cap) - 1   (ref utils/batch_gen.py:326-331)
    batcher, vocab = _make_batcher(mini_coco, batch_size=4)
    b = next(iter(batcher.train_batches(num_captions=1)))
    for i in range(b.valid):
        n = int(b.lengths[i, 0])
        assert n > 0
        assert b.dec_inputs[i, 0, 0] == vocab.bos_id
        assert b.labels[i, 0, n - 1] == vocab.eos_id
        # shifted by one: dec[t+1] == labels[t] for t < n-1
        np.testing.assert_array_equal(b.dec_inputs[i, 0, 1:n],
                                      b.labels[i, 0, : n - 1])
        # padding is zeros
        assert (b.dec_inputs[i, 0, n:] == 0).all()
        assert (b.labels[i, 0, n:] == 0).all()


def test_multi_caption_batches(mini_coco):
    batcher, _ = _make_batcher(mini_coco, batch_size=4)
    b = next(iter(batcher.train_batches(num_captions=5)))
    assert b.dec_inputs.shape[1] == 5
    assert (b.lengths > 0).all()  # every image has 5 captions in fixture


def test_eval_batches_pad_final(mini_coco):
    paths = coco_paths(mini_coco)
    caps = CocoCaptions(paths["valid_cap_json"])
    vocab = Vocabulary.build(caps.all_tokenized(), keep_words=1)
    caps.index_captions(vocab)
    from glob import glob
    files = sorted(glob(os.path.join(paths["valid_dir"], "*.jpg")))

    class FakeFeatures:
        def get_batch(self, fns):
            return np.zeros((len(fns), 4096), np.float32)

    batcher = CaptionBatcher(files, caps.captions_indexed, 4,
                             feature_store=FakeFeatures(),
                             filename_to_imid=caps.filename_to_imid)
    batches = list(batcher.eval_batches())
    assert len(batches) == 2  # 6 images → 4 + 2(padded)
    assert batches[-1].valid == 2
    assert batches[-1].features.shape == (4, 4096)  # padded to full
    assert batches[-1].image_ids.shape == (4,)
    assert (batches[-1].image_ids[2:] == -1).all()
    assert (batches[0].image_ids >= 0).all()


def test_repartition_semantics():
    rng = np.random.default_rng(0)
    train = [f"t{i}" for i in range(10)]
    val = [f"v{i}" for i in range(6)]
    pool, heldout = repartition(train, val, 2, rng)
    assert len(pool) == 14 and len(heldout) == 2
    assert set(pool) | set(heldout) == set(train) | set(val)
    assert not set(pool) & set(heldout)
    # gen_val_cap < 0 → no holdout (ref utils/batch_gen.py:83-90)
    pool2, heldout2 = repartition(train, val, -1, np.random.default_rng(0))
    assert len(pool2) == 16 and heldout2 == []


def test_train_shuffle_deterministic(mini_coco):
    b1, _ = _make_batcher(mini_coco, batch_size=4, seed=7)
    b2, _ = _make_batcher(mini_coco, batch_size=4, seed=7)
    x1 = next(iter(b1.train_batches()))
    x2 = next(iter(b2.train_batches()))
    np.testing.assert_array_equal(x1.dec_inputs, x2.dec_inputs)


# ---------------------------------------------------------------- config

def test_config_roundtrip(tmp_path):
    cfg = Config(prior="AG", use_c_v=True, latent_size=64)
    path = str(tmp_path / "config.json")
    cfg.save(path)
    loaded = Config.load(path)
    assert loaded == cfg


def test_config_cli_flags():
    from vae_captioning.config import parse_args
    cfg = parse_args(["--lr", "0.001", "--bs", "16", "--prior", "AG",
                      "--c_v", "--no_encoder", "--set", "seed=7"])
    assert cfg.learning_rate == 0.001
    assert cfg.batch_size == 16
    assert cfg.prior == "AG"
    assert cfg.use_c_v and cfg.no_encoder
    assert cfg.seed == 7


def test_config_set_coerces_optional_int():
    """--set on an Optional[int] field (default None) must coerce by the
    declared annotation, not the runtime None (which has no type to
    dispatch on) — a string '4096' batch size breaks the batcher."""
    from vae_captioning.config import parse_args
    cfg = parse_args(["--set", "gen_batch_size=4096"])
    assert cfg.gen_batch_size == 4096
    assert isinstance(cfg.gen_batch_size, int)


def test_config_reference_readme_ag_example():
    """The reference README's exact AG training command must parse
    verbatim (ref README.md usage section), incl. the ignored --gpu."""
    import warnings
    from vae_captioning.config import parse_args
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cfg = parse_args(
            ["--gpu", "0", "--embed_dim", "256", "--dec_hid", "512",
             "--epochs", "50", "--temperature", "0.6", "--gen_name", "ag",
             "--dec_drop", "0.7", "--dec_lstm_drop", "0.7", "--lr", "0.001",
             "--checkpoint", "ag_cv_test1", "--coco_dir", "/tmp/coco/",
             "--optimizer", "Adam", "--sample_gen", "greedy", "--c_v",
             "--prior", "AG"])
    assert cfg.embed_size == 256 and cfg.decoder_hidden == 512
    assert cfg.prior == "AG" and cfg.use_c_v and cfg.num_epochs == 50
    assert cfg.dec_keep_rate == 0.7 and cfg.temperature == 0.6
    assert any("--gpu is ignored" in str(x.message) for x in w)


def test_config_validation():
    with pytest.raises(ValueError):
        Config(prior="bogus")
    with pytest.raises(ValueError):
        Config(num_captions=9)


def test_config_needs_cluster_vectors():
    assert Config(prior="AG").needs_cluster_vectors
    assert Config(prior="GMM").needs_cluster_vectors
    assert not Config(prior="Normal").needs_cluster_vectors
    assert Config(prior="Normal", use_c_v=True).needs_cluster_vectors


def test_detections_json_cli(tmp_path, mini_coco):
    import json
    paths = coco_paths(mini_coco)
    dets = [
        {"file_name": "img_a.jpg", "category_id": 3, "score": 0.9},
        {"file_name": "img_a.jpg", "category_id": 7, "score": 0.4},
        {"image_id": 12345, "category_id": 5, "score": 0.8},
    ]
    dp = tmp_path / "dets.json"
    dp.write_text(json.dumps(dets))
    out = str(tmp_path / "c_v_test.npz")
    cv_lib.main(["--detections_json", str(dp), "--output", out,
                 "--score_threshold", "0.5"])
    vecs = cv_lib.load(out)
    assert vecs["img_a.jpg"][3] == 1.0  # only the 0.9 det survives 0.5
    assert vecs["img_a.jpg"][7] == 0.0
    assert vecs["12345"][5] == 1.0


def test_cluster_vector_fallback_counting():
    # per-call counts (no module global): each Batch carries its own
    # fallback count so prefetch threads can't misattribute it (ADVICE r3)
    vecs = {"a.jpg": np.ones(cv_lib.NUM_CATEGORIES, np.float32)}
    out, n = cv_lib.lookup_batch(vecs, ["a.jpg", "b.jpg", "c.jpg"])
    assert out.shape == (3, cv_lib.NUM_CATEGORIES)
    assert n == 2
    _, n2 = cv_lib.lookup_batch(None, ["d.jpg"])
    assert n2 == 1


def test_batch_carries_cv_fallback_count(mini_coco, tmp_path):
    # the batcher attaches the per-batch count; generate_captions
    # aggregates it into the caller's stats dict (ADVICE r3)
    from vae_captioning.data.dataset import Data
    cfg = Config(coco_dir=mini_coco, prior="AG",
                 cache_dir=str(tmp_path / "cache"),
                 obj_vectors_dir=str(tmp_path / "obj"))
    os.makedirs(cfg.obj_vectors_dir, exist_ok=True)
    data = Data(cfg, extract_features=False)
    batcher = data.val_batcher()
    batcher.cluster_vectors = None  # force every lookup to fall back
    batches = list(batcher.eval_batches())
    assert sum(b.cv_fallbacks for b in batches) == len(batcher.filenames)


def _cv_data(mini_coco, tmp_path):
    from vae_captioning.data.dataset import Data
    cfg = Config(coco_dir=mini_coco, prior="AG",
                 cache_dir=str(tmp_path / "cache"),
                 obj_vectors_dir=str(tmp_path / "obj"))
    os.makedirs(cfg.obj_vectors_dir, exist_ok=True)
    return cfg, Data(cfg, extract_features=False)


def test_test_split_zero_vectors_warn_loud(mini_coco, tmp_path):
    # VERDICT r2 #7: a missing c_v_test must not silently move CIDEr
    _, data = _cv_data(mini_coco, tmp_path)
    with pytest.warns(UserWarning, match="ZERO cluster vectors"):
        vecs = data.cluster_vectors(test=True)
    assert vecs == {}


def test_test_split_detections_autoconvert(mini_coco, tmp_path):
    # a COCO-results detections JSON dropped at
    # obj_vectors/test_detections.json is converted automatically —
    # the in-repo stand-in for prepare_test_vectors.ipynb's Faster-RCNN
    import json
    import warnings as _warnings
    cfg, data = _cv_data(mini_coco, tmp_path)
    dets = [{"file_name": "img_0.jpg", "category_id": 3, "score": 0.9},
            {"file_name": "img_0.jpg", "category_id": 7, "score": 0.8}]
    with open(os.path.join(cfg.obj_vectors_dir,
                           "test_detections.json"), "w") as f:
        json.dump(dets, f)
    with _warnings.catch_warnings():
        _warnings.simplefilter("error")  # must NOT warn on this path
        vecs = data.cluster_vectors(test=True)
    assert vecs["img_0.jpg"][3] == pytest.approx(0.5)
    assert vecs["img_0.jpg"][7] == pytest.approx(0.5)
    # converted vectors are cached as the npz the search order prefers
    assert os.path.exists(os.path.join(cfg.obj_vectors_dir, "c_v_test.npz"))


def test_category_index(mini_coco, tmp_path):
    import json
    # fixture instances have no categories section; fabricate one
    inst = {"images": [], "annotations": [],
            "categories": [{"id": 1, "name": "person"},
                           {"id": 18, "name": "dog"}]}
    p = tmp_path / "inst.json"
    p.write_text(json.dumps(inst))
    idx = cv_lib.category_index(str(p))
    assert idx == {1: "person", 18: "dog"}


def test_tokenizer_unicode_and_clipping(tmp_path):
    # unicode word chars survive \W+ (python3 re is unicode-aware)
    assert "café" in tokenize_caption("A café near the river")
    # real caption clipping (the reference's clip is dead code,
    # utils/captions.py:32-34 — ours clips for real)
    import json
    long_cap = " ".join(["word"] * 50)
    j = {"images": [{"id": 1, "file_name": "a.jpg"}],
         "annotations": [{"id": 1, "image_id": 1, "caption": long_cap}]}
    path = tmp_path / "caps.json"
    path.write_text(json.dumps(j))
    caps = CocoCaptions(str(path), max_length=10)
    assert len(caps.captions["a.jpg"][0]) == 10


@pytest.mark.parametrize("module,package", [("cv2", "opencv-python"),
                                            ("h5py", "h5py"),
                                            ("tqdm", "tqdm")])
def test_offline_tool_import_error_names_package(monkeypatch, module,
                                                 package):
    import sys

    from vae_captioning.data.images import optional_import
    monkeypatch.setitem(sys.modules, module, None)
    with pytest.raises(ImportError, match=f"pip install {package}"):
        optional_import(module, package)
