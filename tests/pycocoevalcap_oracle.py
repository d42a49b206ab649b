"""Test-only oracle: a structure-faithful reimplementation of the official
pycocoevalcap (tylin/coco-caption) scorers, for cross-validating
``vae_captioning.eval.scorers`` (VERDICT r2 #1a).

The official package is not installable in this environment (no network,
and its tokenizer shells out to a CoreNLP jar), so this module re-derives
the *exact arithmetic* of the published implementations —
``pycocoevalcap/bleu/bleu_scorer.py`` (David Chiang's BLEU with
tiny/small smoothing and the 'closest' reference-length option),
``pycocoevalcap/cider/cider_scorer.py`` (CIDEr-D, including the
length-from-bigram-counts quirk), and ``pycocoevalcap/rouge/rouge.py``
(ROUGE-L, β=1.2, max-precision/max-recall over refs) — following their
cook/precook code structure so that any deviation in the repo's
formula-derived scorers shows up as a numeric mismatch.

Deliberate quirks preserved from the official code (do NOT "fix"):
  * BLEU precision smoothing: (correct + 1e-15) / (guess + 1e-9) — a
    zero n-gram match yields a small positive precision, not zero.
  * BLEU reference length: option='closest' when the corpus has more
    than one image (ties broken toward the shorter reference), computed
    per image and summed; brevity penalty exp(1 - 1/ratio) applied only
    when ratio = testlen/reflen < 1.
  * CIDEr-D "length" is the sum of *bigram* counts (index n==1 in the
    0-based vec list), i.e. len(words) - 1; deltas are unaffected but
    the structure is kept verbatim.
  * CIDEr-D idf = log(num_images) - log(max(1, df)); the gaussian
    length penalty (σ=6) multiplies the normalized clipped dot product.
  * ROUGE-L: score is 0 when either max precision or max recall is 0.

This file lives under tests/ and is never imported by the package.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Tuple


# ----------------------------------------------------------------------
# BLEU (bleu_scorer.py)
# ----------------------------------------------------------------------

def _bleu_precook(s: str, n: int = 4) -> Tuple[int, Dict[tuple, int]]:
    words = s.split()
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return len(words), counts


def _bleu_cook_refs(refs: List[str], n: int = 4):
    reflen = []
    maxcounts: Dict[tuple, int] = {}
    for ref in refs:
        rl, counts = _bleu_precook(ref, n)
        reflen.append(rl)
        for ngram, count in counts.items():
            maxcounts[ngram] = max(maxcounts.get(ngram, 0), count)
    return reflen, maxcounts


def _bleu_cook_test(test: str, reflen_maxcounts, n: int = 4):
    reflen, refmaxcounts = reflen_maxcounts
    testlen, counts = _bleu_precook(test, n)
    result = {
        "testlen": testlen,
        "reflen": reflen,  # list; resolved per option at compute time
        "guess": [max(0, testlen - k + 1) for k in range(1, n + 1)],
        "correct": [0] * n,
    }
    for ngram, count in counts.items():
        result["correct"][len(ngram) - 1] += min(
            refmaxcounts.get(ngram, 0), count)
    return result


def _single_reflen(reflens: List[int], option: str, testlen: int) -> float:
    if option == "shortest":
        return min(reflens)
    if option == "average":
        return float(sum(reflens)) / len(reflens)
    if option == "closest":
        return min((abs(l - testlen), l) for l in reflens)[1]
    raise ValueError(option)


def oracle_bleu(hypotheses: Dict[str, str],
                references: Dict[str, List[str]],
                n: int = 4, option: str = None) -> List[float]:
    """Corpus BLEU-1..n exactly as BleuScorer.compute_score returns it
    (the corpus-level `bleus` list, not the per-image list)."""
    small = 1e-9
    tiny = 1e-15  # so that if guess is 0 still return 0
    crefs = []
    ctest = []
    for key in hypotheses:
        crefs.append(_bleu_cook_refs(references[key], n))
        ctest.append(_bleu_cook_test(hypotheses[key], crefs[-1], n))
    if option is None:
        option = "average" if len(crefs) == 1 else "closest"
    total_testlen = 0.0
    total_reflen = 0.0
    totalcomps = {"guess": [0] * n, "correct": [0] * n}
    for comps in ctest:
        testlen = comps["testlen"]
        total_testlen += testlen
        total_reflen += _single_reflen(comps["reflen"], option, testlen)
        for key in ("guess", "correct"):
            for k in range(n):
                totalcomps[key][k] += comps[key][k]
    bleus = []
    bleu = 1.0
    for k in range(n):
        bleu *= (float(totalcomps["correct"][k]) + tiny) \
            / (float(totalcomps["guess"][k]) + small)
        bleus.append(bleu ** (1.0 / (k + 1)))
    ratio = (total_testlen + tiny) / (total_reflen + small)
    if ratio < 1:
        for k in range(n):
            bleus[k] *= math.exp(1 - 1 / ratio)
    return bleus


# ----------------------------------------------------------------------
# CIDEr-D (cider_scorer.py)
# ----------------------------------------------------------------------

def _cider_precook(s: str, n: int = 4) -> Dict[tuple, int]:
    words = s.split()
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


def oracle_cider_d(hypotheses: Dict[str, str],
                   references: Dict[str, List[str]],
                   n: int = 4, sigma: float = 6.0) -> float:
    crefs = []
    ctest = []
    for key in hypotheses:
        crefs.append([_cider_precook(r, n) for r in references[key]])
        ctest.append(_cider_precook(hypotheses[key], n))

    document_frequency: Dict[tuple, float] = defaultdict(float)
    for refs in crefs:
        for ngram in set(g for ref in refs for g in ref):
            document_frequency[ngram] += 1
    ref_len = math.log(float(len(crefs)))

    def counts2vec(cnts):
        vec = [defaultdict(float) for _ in range(n)]
        length = 0
        norm = [0.0] * n
        for ngram, term_freq in cnts.items():
            df = math.log(max(1.0, document_frequency[ngram]))
            k = len(ngram) - 1
            vec[k][ngram] = float(term_freq) * (ref_len - df)
            norm[k] += vec[k][ngram] ** 2
            if k == 1:  # official quirk: "length" = bigram count
                length += term_freq
        return vec, [math.sqrt(x) for x in norm], length

    def sim(vec_hyp, vec_ref, norm_hyp, norm_ref, length_hyp, length_ref):
        delta = float(length_hyp - length_ref)
        val = [0.0] * n
        for k in range(n):
            for ngram in vec_hyp[k]:
                val[k] += (min(vec_hyp[k][ngram], vec_ref[k][ngram])
                           * vec_ref[k][ngram])
            if norm_hyp[k] != 0 and norm_ref[k] != 0:
                val[k] /= norm_hyp[k] * norm_ref[k]
            val[k] *= math.e ** (-(delta ** 2) / (2 * sigma ** 2))
        return val

    scores = []
    for test, refs in zip(ctest, crefs):
        vec, norm, length = counts2vec(test)
        score = [0.0] * n
        for ref in refs:
            vec_ref, norm_ref, length_ref = counts2vec(ref)
            s = sim(vec, vec_ref, norm, norm_ref, length, length_ref)
            score = [a + b for a, b in zip(score, s)]
        score_avg = sum(score) / n
        score_avg /= len(refs)
        score_avg *= 10.0
        scores.append(score_avg)
    return sum(scores) / len(scores)


# ----------------------------------------------------------------------
# ROUGE-L (rouge.py)
# ----------------------------------------------------------------------

def _my_lcs(string: List[str], sub: List[str]) -> int:
    if len(string) < len(sub):
        string, sub = sub, string
    lengths = [[0] * (len(sub) + 1) for _ in range(len(string) + 1)]
    for j in range(1, len(sub) + 1):
        for i in range(1, len(string) + 1):
            if string[i - 1] == sub[j - 1]:
                lengths[i][j] = lengths[i - 1][j - 1] + 1
            else:
                lengths[i][j] = max(lengths[i - 1][j], lengths[i][j - 1])
    return lengths[len(string)][len(sub)]


def oracle_rouge_l(hypotheses: Dict[str, str],
                   references: Dict[str, List[str]],
                   beta: float = 1.2) -> float:
    total = 0.0
    for key, hyp in hypotheses.items():
        token_c = hyp.split(" ")
        prec, rec = [], []
        for reference in references[key]:
            token_r = reference.split(" ")
            lcs = _my_lcs(token_r, token_c)
            prec.append(lcs / float(len(token_c)))
            rec.append(lcs / float(len(token_r)))
        prec_max, rec_max = max(prec), max(rec)
        if prec_max != 0 and rec_max != 0:
            total += ((1 + beta ** 2) * prec_max * rec_max) \
                / float(rec_max + beta ** 2 * prec_max)
    return total / len(hypotheses)
