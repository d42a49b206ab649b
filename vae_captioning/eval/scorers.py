"""Caption quality metrics: corpus BLEU-1..4, ROUGE-L, and CIDEr-D.

The reference delegates scoring to the external tylin/coco-caption tool
(``README.md:47``); this module closes the loop in-repo with standard
pure-numpy implementations so a training run can report CIDEr directly.

Algorithms follow the canonical definitions:
  * BLEU (Papineni et al. 2002): modified n-gram precision with corpus
    brevity penalty, uniform weights.
  * ROUGE-L (Lin 2004, coco-caption variant): LCS-based F-measure with
    β = 1.2, per-image max precision/recall over references.
  * CIDEr-D (Vedantam et al. 2015): tf-idf-weighted n-gram cosine
    similarity, n = 1..4, count clipping, gaussian length penalty
    (σ = 6), ×10 scaling.

METEOR ships as the clearly-renamed ``METEOR_es`` (eval/meteor.py):
the official implementation is the METEOR-1.5 Java jar with WordNet
synonym and paraphrase tables, unavailable here — ``METEOR_es`` is the
published algorithm restricted to its exact+Porter-stem stages, for
RELATIVE tracking only (its numbers must never be compared to published
METEOR-1.5 results; see the comparability warning in eval/meteor.py).

Inputs are whitespace-tokenized strings.  ``score_captions_json``
normalizes both sides with ``ptb_tokenize``, which matches coco-caption's
PTBTokenizer (CoreNLP tokenize → lowercase → drop its PUNCTUATIONS list)
on caption-domain text, so the scores are comparable to the official
tylin/coco-caption numbers the reference's CIDEr≈0.8 claim uses
(``/root/reference/README.md:47``).  This is asserted, not assumed:
``tests/test_pyco_parity.py`` checks the tokenizer against 55+ canned
CoreNLP input/output pairs and every scorer against a
structure-faithful oracle of the official pycocoevalcap arithmetic to
≤1e-4 (plus nltk BLEU and hand-derived CIDEr-D/ROUGE-L constants in
``tests/test_eval.py``).
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, List, Sequence

# ----------------------------------------------------------------------
# PTB tokenization (coco-caption parity)
# ----------------------------------------------------------------------

# coco-caption drops exactly these tokens after CoreNLP tokenization
# (pycocoevalcap/tokenizer/ptbtokenizer.py PUNCTUATIONS); CoreNLP maps
# brackets to -LRB- etc. and quotes to ``/'' — we drop the raw forms.
_PTB_PUNCT = {"''", "'", "``", "`", ".", "?", "!", ",", ":", "-", "--",
              "...", ";", '"', "(", ")", "[", "]", "{", "}"}

# CoreNLP's special-cased multiword splits that plausibly occur in captions
_PTB_SPECIALS = {"cannot": "can not", "gonna": "gon na", "wanna": "wan na",
                 "gotta": "got ta", "lemme": "lem me", "gimme": "gim me"}

# words, keeping internal hyphens / slashes / number commas+decimals /
# digit-colon times (3:30) / o'clock-style apostrophes as one token (PTB
# behavior); split-off contraction suffixes (\b-guarded so a quoted
# 'red' does not parse as 're + d); runs of dots/dashes; single symbols.
# $ and % are standalone tokens (PTB separates currency/percent signs;
# they survive the PUNCTUATIONS drop, e.g. "50%" → ["50", "%"]).
_PTB_TOKEN_RE = re.compile(
    r"\d+(?::\d+)+"
    r"|\w+(?:[-/.,']\w+)*"
    r"|'(?:s|re|m|ve|ll|d)\b|n't\b"
    r"|\.\.\.|--|[^\w\s]")


def ptb_tokenize(caption: str) -> List[str]:
    """Lowercase + tokenize one caption the way coco-caption's
    PTBTokenizer does: CoreNLP PTB rules (contraction splits — ``don't``
    → ``do n't``, ``can't`` → ``ca n't``; hyphenated compounds and
    numbers like ``1,000`` stay single tokens; punctuation split off),
    then remove the PUNCTUATIONS list.  Pure-Python stand-in: the
    official tokenizer shells out to the CoreNLP jar, unavailable here."""
    s = caption.lower().strip()
    for word, split in _PTB_SPECIALS.items():
        s = re.sub(rf"\b{word}\b", split, s)
    s = re.sub(r"n't\b", " n't", s)            # don't → do n't, can't → ca n't
    s = re.sub(r"'(s|re|m|ve|ll|d)\b", r" '\1", s)
    return [t for t in _PTB_TOKEN_RE.findall(s) if t not in _PTB_PUNCT]


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


# ----------------------------------------------------------------------
# BLEU
# ----------------------------------------------------------------------

def corpus_bleu(hypotheses: Dict[str, str], references: Dict[str, List[str]],
                max_n: int = 4) -> List[float]:
    """Corpus-level BLEU-1..max_n.  Keys of both dicts are image ids.

    Arithmetic matches pycocoevalcap's BleuScorer.compute_score exactly
    (option='closest', the official eval's setting for multi-image
    corpora): per-image closest reference length with ties broken
    toward the shorter reference, additive tiny/small smoothing on the
    clipped precisions (a zero n-gram match yields ~1e-6, not 0), and
    brevity penalty exp(1 - 1/ratio) applied only when
    ratio = testlen/reflen < 1.  Cross-validated against a
    structure-faithful oracle of the official code in
    tests/test_pyco_parity.py (≤1e-4) and against nltk where the
    smoothing is immaterial (tests/test_eval.py)."""
    small = 1e-9
    tiny = 1e-15  # pycocoevalcap's constants, verbatim
    clipped = [0] * max_n
    totals = [0] * max_n
    hyp_len = 0
    ref_len = 0.0
    # official option resolution: 'average' for a 1-image corpus,
    # 'closest' otherwise
    closest = len(hypotheses) > 1
    for key, hyp in hypotheses.items():
        hyp_tokens = hyp.split()
        refs_tokens = [r.split() for r in references[key]]
        hyp_len += len(hyp_tokens)
        if closest:
            # closest reference length (official BLEU tie→shorter)
            ref_len += min((abs(len(r) - len(hyp_tokens)), len(r))
                           for r in refs_tokens)[1]
        else:
            ref_len += sum(len(r) for r in refs_tokens) / len(refs_tokens)
        for n in range(1, max_n + 1):
            hyp_counts = _ngrams(hyp_tokens, n)
            max_ref = Counter()
            for r in refs_tokens:
                for gram, c in _ngrams(r, n).items():
                    max_ref[gram] = max(max_ref[gram], c)
            totals[n - 1] += sum(hyp_counts.values())
            clipped[n - 1] += sum(min(c, max_ref[g])
                                  for g, c in hyp_counts.items())
    scores = []
    bleu = 1.0
    for n in range(max_n):
        bleu *= (clipped[n] + tiny) / (totals[n] + small)
        scores.append(bleu ** (1.0 / (n + 1)))
    ratio = (hyp_len + tiny) / (ref_len + small)
    if ratio < 1:
        scores = [s * math.exp(1 - 1 / ratio) for s in scores]
    return scores


# ----------------------------------------------------------------------
# ROUGE-L
# ----------------------------------------------------------------------

def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    """Longest-common-subsequence length, O(len(a)·len(b))."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l(hypotheses: Dict[str, str], references: Dict[str, List[str]],
            beta: float = 1.2) -> float:
    """Corpus ROUGE-L: mean per-image F_β over the LCS precision/recall,
    taking the MAX precision and MAX recall over the reference set —
    exactly pycocoevalcap/rouge/rouge.py::Rouge.calc_score."""
    total = 0.0
    for key, hyp in hypotheses.items():
        hyp_tokens = hyp.split()
        prec, rec = [], []
        for r in references[key]:
            ref_tokens = r.split()
            lcs = _lcs_len(hyp_tokens, ref_tokens)
            prec.append(lcs / len(hyp_tokens) if hyp_tokens else 0.0)
            rec.append(lcs / len(ref_tokens) if ref_tokens else 0.0)
        p, r_ = max(prec, default=0.0), max(rec, default=0.0)
        if p != 0 and r_ != 0:
            total += ((1 + beta ** 2) * p * r_) / (r_ + beta ** 2 * p)
    return total / max(len(hypotheses), 1)


# ----------------------------------------------------------------------
# CIDEr-D
# ----------------------------------------------------------------------

def cider_d(hypotheses: Dict[str, str], references: Dict[str, List[str]],
            max_n: int = 4, sigma: float = 6.0) -> float:
    """Corpus CIDEr-D (mean over images, ×10)."""
    # document frequency over reference sets
    df: Dict[tuple, float] = defaultdict(float)
    for refs in references.values():
        seen = set()
        for r in refs:
            toks = r.split()
            for n in range(1, max_n + 1):
                seen.update(_ngrams(toks, n).keys())
        for gram in seen:
            df[gram] += 1.0
    log_num_images = math.log(max(len(references), 1))

    def tfidf_vec(tokens: Sequence[str]):
        vecs, norms = [], []
        length = len(tokens)
        for n in range(1, max_n + 1):
            counts = _ngrams(tokens, n)
            vec = {}
            norm_sq = 0.0
            for gram, c in counts.items():
                idf = log_num_images - math.log(max(df.get(gram, 0.0), 1.0))
                w = c * idf
                vec[gram] = w
                norm_sq += w * w
            vecs.append(vec)
            norms.append(math.sqrt(norm_sq))
        return vecs, norms, length

    total = 0.0
    for key, hyp in hypotheses.items():
        h_vecs, h_norms, h_len = tfidf_vec(hyp.split())
        score_n = [0.0] * max_n
        refs = references[key]
        for r in refs:
            r_vecs, r_norms, r_len = tfidf_vec(r.split())
            delta = float(h_len - r_len)
            len_pen = math.exp(-(delta ** 2) / (2 * sigma ** 2))
            for n in range(max_n):
                # clipped dot product (the -D variant)
                dot = sum(min(w, r_vecs[n].get(g, 0.0)) * r_vecs[n].get(g, 0.0)
                          for g, w in h_vecs[n].items())
                denom = h_norms[n] * r_norms[n]
                if denom > 0:
                    score_n[n] += len_pen * dot / denom
        total += 10.0 * sum(s / len(refs) for s in score_n) / max_n
    return total / max(len(hypotheses), 1)


# ----------------------------------------------------------------------
# COCO-eval JSON entry point
# ----------------------------------------------------------------------

def score_captions_json(results_json_path: str,
                        captions_json_path: str) -> Dict[str, float]:
    """Score a generated ``[{'image_id','caption'}]`` JSON against the COCO
    ground-truth captions file (same inputs as tylin/coco-caption; both
    sides PTB-tokenized like the official pipeline)."""
    import json

    def norm(s: str) -> str:
        return " ".join(ptb_tokenize(s))

    with open(results_json_path) as f:
        results = json.load(f)
    with open(captions_json_path) as f:
        gt = json.load(f)
    refs: Dict[str, List[str]] = defaultdict(list)
    for ann in gt["annotations"]:
        refs[str(ann["image_id"])].append(norm(ann["caption"]))
    hyps = {str(r["image_id"]): norm(r["caption"]) for r in results
            if str(r["image_id"]) in refs}
    missing = len(results) - len(hyps)
    if not hyps:
        raise ValueError("no overlapping image ids between results and GT")
    refs = {k: v for k, v in refs.items() if k in hyps}
    bleu = corpus_bleu(hyps, refs)
    out = {f"BLEU-{i+1}": round(b, 4) for i, b in enumerate(bleu)}
    out["ROUGE-L"] = round(rouge_l(hyps, refs), 4)
    out["CIDEr-D"] = round(cider_d(hyps, refs), 4)
    # METEOR-ES: exact+stem METEOR, NOT comparable to METEOR-1.5 jar
    # numbers (no WordNet synonymy) — relative tracking only, hence the
    # suffixed key; see eval/meteor.py's comparability warning
    from vae_captioning.eval.meteor import corpus_meteor_es
    keys = sorted(hyps)
    out["METEOR_es"] = round(corpus_meteor_es(
        [hyps[k].split() for k in keys],
        [[r.split() for r in refs[k]] for k in keys]), 4)
    out["scored_images"] = len(hyps)
    if missing:
        out["unscored_images"] = missing
    return out


def main(argv=None) -> None:
    import argparse
    import json

    p = argparse.ArgumentParser(description="Score generated captions "
                                "against COCO ground truth")
    p.add_argument("--results", required=True, help="val_<name>.json")
    p.add_argument("--annotations", required=True,
                   help="captions_val2014.json")
    args = p.parse_args(argv)
    print(json.dumps(score_captions_json(args.results, args.annotations),
                     indent=2))


if __name__ == "__main__":
    main()
