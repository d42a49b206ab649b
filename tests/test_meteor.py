"""METEOR-ES oracle validation.

Two independent oracles, both from nltk (already used for BLEU parity):
  * the Porter stemmer vs ``nltk.PorterStemmer(mode="ORIGINAL_ALGORITHM")``
    over a large wordlist (the paper algorithm is the contract);
  * the alignment + score arithmetic vs ``nltk single_meteor_score`` with
    a synonym-free WordNet stub (reduces nltk to exact+stem — exactly the
    METEOR-ES definition) and OUR stemmer injected on both sides, so the
    comparison isolates the alignment/fmean/penalty math.
"""

import random

import pytest

from vae_captioning.eval.meteor import (corpus_meteor_es, meteor_es,
                                            porter_stem)

nltk = pytest.importorskip("nltk")


# ----------------------------------------------------------------- stemmer

WORDS = """caresses ponies ties caress cats feed agreed plastered bled
motoring sing conflated troubled sized hopping tanned falling hissing
fizzed failing filing happy sky relational conditional rational valenci
hesitanci digitizer conformabli radicalli differentli vileli analogousli
vietnamization predication operator feudalism decisiveness hopefulness
callousness formaliti sensitiviti sensibiliti triplicate formative
formalize electriciti electrical hopeful goodness revival allowance
inference airliner gyroscopic adjustable defensible irritant replacement
adjustment dependent adoption homologou communism activate angulariti
homologous effective bowdlerize probate rate cease controll roll
generalization generalizations oscillators oscillator running runner
eating eaten walked walking jumped jumps playing played plays skies
flies crying cried babies dogs horses riding rides surfing surfed
standing stands sitting sits holding holds wearing wears smiling smiled
colorful beautiful happily quickly slowly really very large small
children woman women man men person people group crowd street streets
building buildings computer keyboard skateboard skateboarding umbrella
umbrellas giraffe giraffes zebra zebras elephant elephants broccoli
sandwich sandwiches pizza pizzas luggage suitcase bananas orange oranges
motorcycle motorcycles bicycle bicycles airplane airplanes televisions
refrigerator microwave toothbrush scissors teddy frisbee snowboard
surfboard racket kite baseball skis parking meter bench bird dog cat
horse sheep cow bear backpack handbag tie bottle glass fork knife spoon
bowl apple chair couch bed toilet laptop mouse remote keyboard phone
oven toaster sink book clock vase drier generously national immaterial
probabilistic characterization maximization capitalistic""".split()


def test_porter_stem_matches_nltk_original_mode():
    from nltk.stem.porter import PorterStemmer
    oracle = PorterStemmer(mode="ORIGINAL_ALGORITHM")
    diffs = [(w, porter_stem(w), oracle.stem(w)) for w in WORDS
             if porter_stem(w) != oracle.stem(w)]
    assert not diffs, diffs[:10]


def test_porter_stem_random_letterstrings_match_oracle():
    """Fuzz beyond real words: the algorithm is defined on any string."""
    from nltk.stem.porter import PorterStemmer
    oracle = PorterStemmer(mode="ORIGINAL_ALGORITHM")
    rng = random.Random(0)
    for _ in range(400):
        n = rng.randint(1, 12)
        w = "".join(rng.choice("abcdefgilmnoprstuyz") for _ in range(n))
        assert porter_stem(w) == oracle.stem(w), w


def test_porter_paper_examples():
    # from the 1980 paper's worked examples
    assert porter_stem("caresses") == "caress"
    assert porter_stem("ponies") == "poni"
    assert porter_stem("feed") == "feed"
    # the paper's step-1b illustration shows agreed → agree; step 5a
    # then drops the final e (m=1, not *o) — official voc output: agre
    assert porter_stem("agreed") == "agre"
    assert porter_stem("motoring") == "motor"
    assert porter_stem("hopping") == "hop"
    assert porter_stem("relational") == "relat"
    assert porter_stem("vietnamization") == "vietnam"
    assert porter_stem("triplicate") == "triplic"
    assert porter_stem("adjustment") == "adjust"


# ----------------------------------------------------------------- meteor


class _NoSynonyms:
    """WordNet stub: no synsets → nltk's wordnet stage matches nothing,
    reducing single_meteor_score to exact+stem (= METEOR-ES)."""

    def synsets(self, word):
        return []


class _OurStemmer:
    def stem(self, word):
        return porter_stem(word)


def _nltk_meteor(hyp, refs):
    from nltk.translate.meteor_score import single_meteor_score
    return max(single_meteor_score(
        r, hyp, stemmer=_OurStemmer(), wordnet=_NoSynonyms())
        for r in refs)


CASES = [
    (["a", "dog", "runs", "on", "the", "grass"],
     [["the", "dog", "is", "running", "on", "grass"]]),
    (["a", "man", "riding", "a", "horse"],
     [["a", "person", "rides", "a", "brown", "horse"],
      ["a", "man", "on", "a", "horse"]]),
    (["two", "cats"], [["two", "cats"]]),                    # perfect
    (["no", "overlap", "here"], [["completely", "different"]]),
    (["a", "a", "a", "b"], [["a", "b", "a"]]),               # duplicates
    (["eating", "pizza"], [["eats", "pizzas", "happily"]]),  # stem-only
]


def test_meteor_es_matches_nltk_on_cases():
    for hyp, refs in CASES:
        ours = meteor_es(hyp, refs)
        oracle = _nltk_meteor(hyp, refs)
        assert ours == pytest.approx(oracle, abs=1e-12), (hyp, refs)


def test_meteor_es_matches_nltk_fuzz():
    rng = random.Random(1)
    vocab = ["a", "the", "dog", "dogs", "cat", "running", "runs", "on",
             "grass", "man", "men", "riding", "rides", "horse", "street",
             "holding", "holds", "red", "blue", "plays", "playing"]
    for _ in range(200):
        hyp = [rng.choice(vocab) for _ in range(rng.randint(1, 12))]
        refs = [[rng.choice(vocab) for _ in range(rng.randint(1, 14))]
                for _ in range(rng.randint(1, 3))]
        assert meteor_es(hyp, refs) == pytest.approx(
            _nltk_meteor(hyp, refs), abs=1e-12), (hyp, refs)


def test_meteor_es_perfect_and_zero():
    assert meteor_es(["x", "y"], [["x", "y"]]) == pytest.approx(
        0.5 / (0.9 * 1 + 0.1 * 1) * (1 - 0.5 * (1 / 2) ** 3) * 2)
    assert meteor_es(["x"], [["y"]]) == 0.0
    assert meteor_es([], [["y"]]) == 0.0
    assert meteor_es(["x"], []) == 0.0


def test_corpus_meteor_es():
    hyps = [["a", "dog"], ["a", "cat"]]
    refs = [[["a", "dog"]], [["the", "cat", "sits"]]]
    per = [meteor_es(h, r) for h, r in zip(hyps, refs)]
    assert corpus_meteor_es(hyps, refs) == pytest.approx(sum(per) / 2)
    with pytest.raises(ValueError):
        corpus_meteor_es(hyps, refs[:1])
