"""Caption metrics in pure Python (counterpart of
`visionllm_tpu/eval/caption.py`): CIDEr-D from its published definition
(tf-idf weighted 1-4-gram cosine similarity, candidate counts clipped to
the reference's, a gaussian length penalty with sigma 6, x10, mean over
n) and corpus BLEU-4 with the brevity penalty.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import List, Sequence


def _tokenize(s: str) -> List[str]:
    s = s.lower()
    s = re.sub(r"[^a-z0-9 ]+", " ", s)
    return s.split()


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


class CiderD:
    """compute(candidates, references) where candidates: list[str],
    references: list[list[str]] aligned by index."""

    def __init__(self, max_n: int = 4, sigma: float = 6.0):
        self.max_n = max_n
        self.sigma = sigma

    def compute(self, candidates: Sequence[str],
                references: Sequence[Sequence[str]]) -> float:
        assert len(candidates) == len(references)
        N = len(candidates)
        # document frequencies over reference sets
        df = [defaultdict(int) for _ in range(self.max_n)]
        ref_tokens = [[_tokenize(r) for r in refs] for refs in references]
        for refs in ref_tokens:
            for n in range(self.max_n):
                seen = set()
                for r in refs:
                    seen |= set(_ngrams(r, n + 1))
                for g in seen:
                    df[n][g] += 1
        log_n = math.log(max(N, 1))

        def tfidf(counts: Counter, n: int):
            vec = {}
            norm = 0.0
            for g, c in counts.items():
                w = c * (log_n - math.log(max(df[n][g], 1)))
                vec[g] = w
                norm += w * w
            return vec, math.sqrt(norm)

        total = 0.0
        for cand, refs in zip(candidates, ref_tokens):
            ct = _tokenize(cand)
            score_n = [0.0] * self.max_n
            for n in range(self.max_n):
                c_counts = _ngrams(ct, n + 1)
                c_vec, c_norm = tfidf(c_counts, n)
                for r in refs:
                    r_counts = _ngrams(r, n + 1)
                    r_vec, r_norm = tfidf(r_counts, n)
                    # CIDEr-D clips candidate counts to reference counts
                    num = 0.0
                    for g, w in c_vec.items():
                        if g in r_vec:
                            idf = (log_n - math.log(max(df[n][g], 1)))
                            clipped = min(c_counts[g], r_counts[g]) * idf
                            num += clipped * r_vec[g]
                    sim = num / (c_norm * r_norm) if c_norm and r_norm else 0.0
                    delta = len(ct) - len(r)
                    sim *= math.exp(-(delta ** 2) / (2 * self.sigma ** 2))
                    score_n[n] += sim / len(refs)
            total += 10.0 * sum(score_n) / self.max_n
        return total / max(N, 1)


def bleu4(candidates: Sequence[str],
          references: Sequence[Sequence[str]]) -> float:
    """Corpus BLEU-4 with brevity penalty (uniform weights)."""
    p_num = [0] * 4
    p_den = [0] * 4
    c_len = r_len = 0
    for cand, refs in zip(candidates, references):
        ct = _tokenize(cand)
        rts = [_tokenize(r) for r in refs]
        c_len += len(ct)
        r_len += min((abs(len(r) - len(ct)), len(r)) for r in rts)[1]
        for n in range(4):
            cg = _ngrams(ct, n + 1)
            max_ref = Counter()
            for r in rts:
                rg = _ngrams(r, n + 1)
                for g, c in rg.items():
                    max_ref[g] = max(max_ref[g], c)
            p_num[n] += sum(min(c, max_ref[g]) for g, c in cg.items())
            p_den[n] += max(sum(cg.values()), 1)
    logp = 0.0
    for n in range(4):
        if p_num[n] == 0:
            return 0.0
        logp += math.log(p_num[n] / p_den[n]) / 4
    bp = 1.0 if c_len > r_len else math.exp(1 - r_len / max(c_len, 1))
    return bp * math.exp(logp)
