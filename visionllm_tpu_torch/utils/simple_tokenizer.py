"""Deterministic word-level tokenizer (tokenizer-free smoke runs + tests);
own copy of the JAX package's `utils/simple_tokenizer.py`, with its
`RoundTripTokenizer`, and `HashedWordTokenizer` (the port's: a fixed
vocabulary, so threads and runs agree on every id).

Mimics the HF LlamaTokenizer interface surface the data layer touches:
callable → .input_ids with a leading BOS, special tokens (bracketed /
angled) as single ids, pad/bos ids, `legacy` flag.
"""

import re
import threading
import zlib
from typing import List

from visionllm_tpu_torch.constants import DEFAULT_TOKENS

SPECIAL = list(DEFAULT_TOKENS.values()) + ["<|im_start|>", "<|im_end|>"]
_PATTERN = re.compile(
    "(" + "|".join(re.escape(s) for s in
                   sorted(SPECIAL, key=len, reverse=True)) + ")")


class _Enc:
    def __init__(self, ids):
        self.input_ids = ids


class SimpleTokenizer:
    bos_token_id = 1
    eos_token_id = 2
    pad_token_id = 0
    legacy = True
    model_max_length = 4096

    def __init__(self):
        # special tokens at stable ids, matching SpecialTokenIds.synthetic
        order = ["img", "imp", "reg", "boi", "eoi", "sor", "eor", "sod",
                 "eod", "sog", "eog", "det", "grd", "seg", "pose", "gen",
                 "edit", "emb", "emb2", "emb3", "emb4", "emb5", "emb6",
                 "emb7", "emb8"]
        self.vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3}
        base = 32000
        for i, k in enumerate(order):
            self.vocab[DEFAULT_TOKENS[k]] = base + i
        self.vocab["<|im_start|>"] = base + len(order)
        self.vocab["<|im_end|>"] = base + len(order) + 1
        self._next = 4
        self._lock = threading.Lock()

    def _word_id(self, w: str) -> int:
        # the loader's threads tokenize concurrently: without the lock
        # two new words can read the same `_next`
        with self._lock:
            if w not in self.vocab:
                self.vocab[w] = self._next
                self._next += 1
                if self._next >= 31000:
                    self._next = 4
            return self.vocab[w]

    def tokenize_str(self, text: str) -> List[int]:
        ids = []
        for part in _PATTERN.split(text):
            if not part:
                continue
            if part in self.vocab and part in SPECIAL:
                ids.append(self.vocab[part])
            else:
                for w in part.replace(",", " ,").replace(".", " .").split():
                    ids.append(self._word_id(w))
        return ids

    def __call__(self, text, **kw):
        if isinstance(text, list):
            return _Enc([[self.bos_token_id] + self.tokenize_str(t)
                         for t in text])
        return _Enc([self.bos_token_id] + self.tokenize_str(text))

    def convert_tokens_to_ids(self, tok: str) -> int:
        return self.vocab.get(tok, 3)

    def decode(self, ids, **kw):
        rev = {v: k for k, v in self.vocab.items()}
        return " ".join(rev.get(int(i), "<unk>") for i in ids)


class RoundTripTokenizer(SimpleTokenizer):
    """SimpleTokenizer whose decode -> encode round-trips for ANY id: ids
    without a vocab word render as "tN" and encode back to N. Session KV
    reuse matches the re-rendered history against the cached token
    prefix, so multi-turn runs with random weights need generated ids to
    survive the text round trip (the word-level decode maps them all to
    one "<unk>", which never matches)."""

    def decode(self, ids, skip_special_tokens=False, **kw):
        rev = {v: k for k, v in self.vocab.items()}
        out = []
        for i in ids:
            i = int(i)
            special = i < 4 or i >= 32000
            if special and skip_special_tokens:
                continue
            name = rev.get(i)
            out.append(name if name is not None else f"t{i}")
        return " ".join(out)

    def _word_id(self, w: str) -> int:
        if len(w) > 1 and w[0] == "t" and w[1:].isdigit():
            return int(w[1:])
        return super()._word_id(w)


class HashedWordTokenizer(SimpleTokenizer):
    """SimpleTokenizer with a fixed vocabulary, as a real tokenizer has:
    a word's id is a hash of the word (crc32 into [4, 31000)), not the
    order in which words were first met, so samples tokenized on loader
    threads in any order, or in another run, get the same ids. Its
    `decode` names only the special tokens."""

    def _word_id(self, w: str) -> int:
        return 4 + zlib.crc32(w.encode()) % (31000 - 4)
