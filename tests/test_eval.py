"""Scorer tests: BLEU/CIDEr-D sanity properties + the COCO-eval JSON
entry point, and the metrics logger."""

import json
import math

import pytest

from vae_captioning.eval.scorers import (
    cider_d, corpus_bleu, score_captions_json)


REFS = {
    "1": ["a man rides a horse on the beach",
          "a person riding a horse near the ocean"],
    "2": ["two dogs play with a red ball",
          "dogs playing with a ball in the park"],
    "3": ["a bus parked at the station",
          "a large bus near a train station"],
}


def test_bleu_perfect_match():
    hyps = {k: v[0] for k, v in REFS.items()}
    scores = corpus_bleu(hyps, REFS)
    assert all(s == pytest.approx(1.0) for s in scores)


def test_bleu_no_overlap():
    hyps = {k: "zzz qqq xxx www vvv" for k in REFS}
    scores = corpus_bleu(hyps, REFS)
    assert scores[0] == pytest.approx(0.0, abs=1e-6)


def test_bleu_orders_quality():
    good = {"1": "a man rides a horse on the beach",
            "2": "two dogs play with a ball",
            "3": "a bus parked near the station"}
    bad = {"1": "a man walks", "2": "dogs", "3": "the the the the"}
    g = corpus_bleu(good, REFS)
    b = corpus_bleu(bad, REFS)
    assert g[3] > b[3]


def test_bleu_brevity_penalty():
    # a 2-word prefix of an 8-word reference must be penalized
    hyps = {"1": "a man"}
    refs = {"1": ["a man rides a horse on the beach"]}
    s = corpus_bleu(hyps, refs)
    assert s[0] < math.exp(1 - 8 / 2) + 1e-9  # bp bound


def test_cider_identical_beats_partial():
    hyps_perfect = {k: v[0] for k, v in REFS.items()}
    hyps_partial = {"1": "a man on the beach", "2": "two dogs in the park",
                    "3": "a bus"}
    perfect = cider_d(hyps_perfect, REFS)
    partial = cider_d(hyps_partial, REFS)
    assert perfect > partial > 0.0
    assert perfect <= 10.0 + 1e-6


def test_cider_zero_for_disjoint():
    hyps = {k: "zzz qqq" for k in REFS}
    assert cider_d(hyps, REFS) == pytest.approx(0.0, abs=1e-6)


# ----------------------------------------------------------------------
# scorer validation vs official behavior (ADVICE r1: the CIDEr-parity
# measurement must not rest on an unvalidated scorer)
# ----------------------------------------------------------------------

def test_ptb_tokenize_matches_corenlp_cases():
    """Outputs must equal what coco-caption's PTBTokenizer (CoreNLP +
    PUNCTUATIONS drop + lowercase) produces for these caption-domain
    inputs."""
    from vae_captioning.eval.scorers import ptb_tokenize
    cases = {
        "A man rides a horse.": ["a", "man", "rides", "a", "horse"],
        "The dog doesn't run!": ["the", "dog", "does", "n't", "run"],
        "It's a well-lit room, isn't it?":
            ["it", "'s", "a", "well-lit", "room", "is", "n't", "it"],
        "He can't swim; she won't either.":
            ["he", "ca", "n't", "swim", "she", "wo", "n't", "either"],
        'A sign reads "STOP" here.': ["a", "sign", "reads", "stop", "here"],
        "Over 1,000 people -- maybe 2.5 million...":
            ["over", "1,000", "people", "maybe", "2.5", "million"],
        "You cannot park (here).": ["you", "can", "not", "park", "here"],
        "It's 5 o'clock somewhere.":
            ["it", "'s", "5", "o'clock", "somewhere"],
        "black/white cat": ["black/white", "cat"],
        "the dogs' ball": ["the", "dogs", "ball"],
    }
    for raw, want in cases.items():
        assert ptb_tokenize(raw) == want, (raw, ptb_tokenize(raw))


def test_corpus_bleu_matches_nltk():
    """Cross-validate BLEU-1..4 against nltk's reference implementation
    (same Papineni corpus BLEU: closest-ref-length BP, no smoothing) on
    random multi-reference corpora."""
    import numpy as np
    from nltk.translate.bleu_score import corpus_bleu as nltk_bleu

    rng = np.random.default_rng(0)
    vocab = ["a", "b", "c", "d", "e", "f"]
    for seed in range(3):
        rng = np.random.default_rng(seed)
        hyps, refs = {}, {}
        nltk_refs, nltk_hyps = [], []
        for i in range(12):
            def sent():
                L = int(rng.integers(5, 12))
                return [vocab[int(j)] for j in rng.integers(0, 6, L)]
            h = sent()
            rs = [sent() for _ in range(int(rng.integers(1, 4)))]
            hyps[str(i)] = " ".join(h)
            refs[str(i)] = [" ".join(r) for r in rs]
            nltk_hyps.append(h)
            nltk_refs.append(rs)
        ours = corpus_bleu(hyps, refs)
        for n in range(1, 5):
            w = tuple([1.0 / n] * n)
            expected = nltk_bleu(nltk_refs, nltk_hyps, weights=w)
            if expected < 1e-9:
                # zero clipped n-gram count: nltk returns a hard 0 while
                # pycocoevalcap (whose arithmetic corpus_bleu follows —
                # see tests/test_pyco_parity.py) smooths to ~1e-6·…;
                # both mean "no n-gram overlap"
                assert ours[n - 1] < 1e-4, (seed, n, ours[n - 1])
            else:
                assert ours[n - 1] == pytest.approx(expected, rel=1e-6), \
                    (seed, n, ours[n - 1], expected)


def test_cider_d_hand_derived_exact_match():
    """2 images with disjoint single references, hypotheses identical to
    the references: every n-gram has idf=log2, each cosine term is 1, so
    CIDEr-D = 10 exactly (Vedantam et al. defs = pycocoevalcap algo)."""
    refs = {"1": ["a b c d"], "2": ["e f g h"]}
    hyps = {"1": "a b c d", "2": "e f g h"}
    assert cider_d(hyps, refs) == pytest.approx(10.0, abs=1e-9)


def test_cider_d_hand_derived_partial_overlap():
    """img2 hyp 'e f x y' vs ref 'e f g h' (all idf=log2, len_pen=1):
    n=1: dot=2·log2², norms (2log2)(2log2) → 1/2
    n=2: common {e f}: 1·log2² / (√3·√3·log2²) → 1/3
    n=3, n=4: no common grams → 0
    image score = 10·(1/2+1/3)/4 = 25/12; corpus mean with the exact-match
    image (10) = (10 + 25/12)/2."""
    refs = {"1": ["a b c d"], "2": ["e f g h"]}
    hyps = {"1": "a b c d", "2": "e f x y"}
    expected = (10.0 + 10.0 * (0.5 + 1.0 / 3.0) / 4.0) / 2.0
    assert cider_d(hyps, refs) == pytest.approx(expected, abs=1e-9)


def test_cider_d_hand_derived_count_clipping():
    """The -D variant clips hyp counts at the ref count: hyp 'a a a a'
    vs ref 'a b c d' → n=1 dot = min(4log2, log2)·log2 = log2², norms
    (4log2)(2log2) → 1/8; bigram 'a a' not in ref → 0 for n≥2.
    Image score = 10·(1/8)/4 = 0.3125; mean with exact img2 = 5.15625."""
    refs = {"1": ["a b c d"], "2": ["e f g h"]}
    hyps = {"1": "a a a a", "2": "e f g h"}
    expected = (10.0 * (1.0 / 8.0) / 4.0 + 10.0) / 2.0
    assert cider_d(hyps, refs) == pytest.approx(expected, abs=1e-9)


def test_cider_d_hand_derived_length_penalty():
    """hyp = ref + 4 novel words ('a b c d x y z w' vs 'a b c d'):
    delta=4 → pen=exp(-16/72); cosines per n: 4/(√8·2), 3/(√7·√3),
    2/(√6·√2), 1/(√5·1)."""
    refs = {"1": ["a b c d"], "2": ["e f g h"]}
    hyps = {"1": "a b c d x y z w", "2": "e f g h"}
    pen = math.exp(-16.0 / (2 * 6.0 ** 2))
    cos = (4 / (math.sqrt(8) * 2) + 3 / math.sqrt(21)
           + 2 / math.sqrt(12) + 1 / math.sqrt(5))
    expected = (10.0 * pen * cos / 4.0 + 10.0) / 2.0
    assert cider_d(hyps, refs) == pytest.approx(expected, abs=1e-9)


def test_score_captions_json(tmp_path):
    results = [{"image_id": 10, "caption": "A man rides a horse."},
               {"image_id": 11, "caption": "Two dogs play."}]
    gt = {"images": [{"id": 10, "file_name": "a.jpg"},
                     {"id": 11, "file_name": "b.jpg"}],
          "annotations": [
              {"id": 1, "image_id": 10, "caption": "a man rides a horse"},
              {"id": 2, "image_id": 10, "caption": "a person on a horse"},
              {"id": 3, "image_id": 11, "caption": "two dogs play outside"},
              {"id": 4, "image_id": 11, "caption": "dogs playing"}]}
    rp = tmp_path / "results.json"
    gp = tmp_path / "gt.json"
    rp.write_text(json.dumps(results))
    gp.write_text(json.dumps(gt))
    out = score_captions_json(str(rp), str(gp))
    assert out["scored_images"] == 2
    assert out["BLEU-1"] > 0.8
    assert out["CIDEr-D"] > 0.0


def test_metric_logger(tmp_path):
    from vae_captioning.utils.logging import MetricLogger
    logger = MetricLogger(str(tmp_path), echo=False, run_name="t")
    logger.log(1, {"loss": 1.5}, epoch=0)
    logger.log(2, {"loss": 1.2}, epoch=0)
    logger.close()
    lines = (tmp_path / "t.metrics.jsonl").read_text().strip().splitlines()
    assert len(lines) == 2
    rec = json.loads(lines[1])
    assert rec["step"] == 2 and rec["loss"] == 1.2


# ---------------------------------------------------------------- ROUGE-L

def test_rouge_l_perfect_match():
    from vae_captioning.eval.scorers import rouge_l
    h = {"1": "the cat sat on the mat"}
    r = {"1": ["the cat sat on the mat"]}
    assert rouge_l(h, r) == pytest.approx(1.0)


def test_rouge_l_hand_derived():
    """p = r = 3/4 → F_β = 3/4 regardless of β (p == r cancels it);
    and max-precision / max-recall may come from DIFFERENT references
    (pycocoevalcap Rouge.calc_score semantics)."""
    from vae_captioning.eval.scorers import rouge_l
    assert rouge_l({"1": "a b c d"}, {"1": ["a c d e"]}) == \
        pytest.approx(0.75)
    # ref1: p=1, r=3/7; ref2: p=2/3, r=2/3 → max p=1, max r=2/3
    beta = 1.2
    p, r = 1.0, 2.0 / 3.0
    want = ((1 + beta ** 2) * p * r) / (r + beta ** 2 * p)
    got = rouge_l({"1": "a b c"}, {"1": ["a b c x x x x", "a z c"]})
    assert got == pytest.approx(want)


def test_rouge_l_in_json_scores(tmp_path):
    import json
    from vae_captioning.eval.scorers import score_captions_json
    res = [{"image_id": 1, "caption": "a dog runs in the park"}]
    gt = {"annotations": [
        {"image_id": 1, "caption": "a dog runs in the park."},
        {"image_id": 1, "caption": "the dog is running outside"}]}
    rp = tmp_path / "res.json"
    gp = tmp_path / "gt.json"
    rp.write_text(json.dumps(res))
    gp.write_text(json.dumps(gt))
    out = score_captions_json(str(rp), str(gp))
    assert out["ROUGE-L"] == pytest.approx(1.0)
    assert out["BLEU-1"] == pytest.approx(1.0)
