"""WordPiece tokenization for BERT-style preprocessing (the port's own
copy of ``skycomputing_tpu/dataset/glue/tokenization.py``; stdlib only).

``BertTokenizer`` is basic tokenization (whitespace, punctuation and CJK
splitting, optional lower-casing with accent stripping) followed by
greedy longest-match-first WordPiece over a ``vocab.txt`` with ``##``
continuation prefixes; ``build_synthetic_vocab`` and
``train_wordpiece_vocab`` make vocabularies offline.
"""

from __future__ import annotations

import collections
import unicodedata
from typing import Dict, List, Optional


def load_vocab(vocab_file: str) -> Dict[str, int]:
    """vocab.txt (one token per line) -> token->id map.

    Ids are assigned by line number unconditionally so they match the row
    indices of a pretrained checkpoint's embedding table even when the file
    contains blank or duplicate lines (duplicates keep their last id, as in
    the canonical BERT loader).
    """
    vocab = collections.OrderedDict()
    with open(vocab_file, encoding="utf-8") as fh:
        for index, line in enumerate(fh):
            token = line.rstrip("\n")
            if token:
                vocab[token] = index
    return vocab


def whitespace_tokenize(text: str) -> List[str]:
    text = text.strip()
    return text.split() if text else []


def _is_whitespace(ch: str) -> bool:
    return ch in (" ", "\t", "\n", "\r") or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class BasicTokenizer:
    """Whitespace/punctuation/CJK splitting with optional lower-casing."""

    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._pad_cjk(text)
        tokens = whitespace_tokenize(text)
        out: List[str] = []
        for token in tokens:
            if self.do_lower_case:
                token = token.lower()
                token = self._strip_accents(token)
            out.extend(self._split_punct(token))
        return whitespace_tokenize(" ".join(out))

    @staticmethod
    def _clean(text: str) -> str:
        chars = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            chars.append(" " if _is_whitespace(ch) else ch)
        return "".join(chars)

    @staticmethod
    def _pad_cjk(text: str) -> str:
        chars = []
        for ch in text:
            if _is_cjk(ord(ch)):
                chars.append(f" {ch} ")
            else:
                chars.append(ch)
        return "".join(chars)

    @staticmethod
    def _strip_accents(text: str) -> str:
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_punct(token: str) -> List[str]:
        pieces: List[List[str]] = []
        start_new = True
        for ch in token:
            if _is_punctuation(ch):
                pieces.append([ch])
                start_new = True
            else:
                if start_new:
                    pieces.append([])
                    start_new = False
                pieces[-1].append(ch)
        return ["".join(p) for p in pieces]


class WordpieceTokenizer:
    """Greedy longest-match-first sub-word tokenization."""

    def __init__(
        self,
        vocab: Dict[str, int],
        unk_token: str = "[UNK]",
        max_input_chars_per_word: int = 200,
    ):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word

    def tokenize(self, text: str) -> List[str]:
        output: List[str] = []
        for token in whitespace_tokenize(text):
            chars = list(token)
            if len(chars) > self.max_input_chars_per_word:
                output.append(self.unk_token)
                continue
            start = 0
            pieces: List[str] = []
            bad = False
            while start < len(chars):
                end = len(chars)
                cur = None
                while start < end:
                    piece = "".join(chars[start:end])
                    if start > 0:
                        piece = "##" + piece
                    if piece in self.vocab:
                        cur = piece
                        break
                    end -= 1
                if cur is None:
                    bad = True
                    break
                pieces.append(cur)
                start = end
            output.extend([self.unk_token] if bad else pieces)
        return output


class BertTokenizer:
    """Full BERT tokenizer: basic split then WordPiece, with id conversion."""

    def __init__(
        self,
        vocab_file: Optional[str] = None,
        do_lower_case: bool = True,
        vocab: Optional[Dict[str, int]] = None,
        max_len: int = 512,
    ):
        if vocab is None:
            if vocab_file is None:
                raise ValueError("either vocab or vocab_file is required")
            vocab = load_vocab(vocab_file)
        self.vocab = vocab
        self.ids_to_tokens = {v: k for k, v in vocab.items()}
        self.basic_tokenizer = BasicTokenizer(do_lower_case=do_lower_case)
        self.wordpiece_tokenizer = WordpieceTokenizer(vocab=vocab)
        self.max_len = max_len

    def tokenize(self, text: str) -> List[str]:
        tokens: List[str] = []
        for token in self.basic_tokenizer.tokenize(text):
            tokens.extend(self.wordpiece_tokenizer.tokenize(token))
        return tokens

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        unk = self.vocab.get("[UNK]", 0)
        ids = [self.vocab.get(t, unk) for t in tokens]
        if len(ids) > self.max_len:
            raise ValueError(
                f"sequence of {len(ids)} tokens exceeds max_len={self.max_len}"
            )
        return ids

    def convert_ids_to_tokens(self, ids: List[int]) -> List[str]:
        return [self.ids_to_tokens[i] for i in ids]


SPECIAL_TOKENS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def train_wordpiece_vocab(
    texts,
    vocab_size: int = 8000,
    min_frequency: int = 2,
    do_lower_case: bool = True,
    num_merges_per_round: int = 200,
) -> Dict[str, int]:
    """Learn a WordPiece vocabulary from raw texts (BPE-style training).

    The reference only ships a *loader* for pretrained vocab files; this
    trainer closes the loop for from-scratch corpora.  Standard algorithm:
    words become character sequences (continuations prefixed ``##``), then
    the highest-frequency adjacent pair is merged repeatedly until the
    vocabulary budget is spent.  Greedy longest-match tokenization with the
    result reconstructs training words exactly.

    ``vocab_size`` caps the TOTAL vocabulary (special tokens + base
    characters + merged subwords).  The specials and the corpus's
    base-character inventory are always included even when they alone
    exceed the budget — dropping them would make training words
    untokenizable — so tiny budgets are overshot, and large budgets spend
    ``vocab_size - specials - characters`` entries on merges.
    """
    basic = BasicTokenizer(do_lower_case=do_lower_case)
    word_freq: Dict[str, int] = collections.Counter()
    for text in texts:
        for word in basic.tokenize(text):
            word_freq[word] += 1

    # each word as a tuple of current symbols
    words = {
        w: [w[0]] + ["##" + ch for ch in w[1:]]
        for w, f in word_freq.items()
        if f >= min_frequency
    }

    vocab = collections.OrderedDict(
        (t, i) for i, t in enumerate(SPECIAL_TOKENS)
    )

    def add(token: str) -> None:
        if token not in vocab:
            vocab[token] = len(vocab)

    for symbols in words.values():
        for s in symbols:
            add(s)

    while len(vocab) < vocab_size:
        pair_freq: Dict[tuple, int] = collections.Counter()
        for w, symbols in words.items():
            f = word_freq[w]
            for a, b in zip(symbols, symbols[1:]):
                pair_freq[(a, b)] += f
        if not pair_freq:
            break
        # merge a batch of top pairs per round, applied in ONE pass per
        # word (left-to-right, higher-frequency pair wins on overlap):
        # one-pair-per-corpus-scan training is O(vocab * corpus), and so
        # is scanning once per batched pair — batching trades exact
        # merge order for a num_merges_per_round speedup
        merges: Dict[tuple, str] = {}
        for (a, b), f in pair_freq.most_common(num_merges_per_round):
            if len(vocab) + len(merges) >= vocab_size or f < min_frequency:
                break
            merged = a + b.removeprefix("##")
            if merged in vocab or merged in merges.values():
                continue
            merges[(a, b)] = merged
        if not merges:
            break
        for merged in merges.values():
            add(merged)
        for w, symbols in words.items():
            out = []
            i = 0
            while i < len(symbols):
                if (
                    i + 1 < len(symbols)
                    and (symbols[i], symbols[i + 1]) in merges
                ):
                    out.append(merges[(symbols[i], symbols[i + 1])])
                    i += 2
                else:
                    out.append(symbols[i])
                    i += 1
            words[w] = out
    return vocab


def build_synthetic_vocab(size: int = 1024, seed: int = 0) -> Dict[str, int]:
    """Deterministic toy vocabulary for offline/zero-download operation."""
    import random

    rng = random.Random(seed)
    vocab = collections.OrderedDict((t, i) for i, t in enumerate(SPECIAL_TOKENS))
    alphabet = "abcdefghijklmnopqrstuvwxyz"
    while len(vocab) < size:
        length = rng.randint(2, 8)
        word = "".join(rng.choice(alphabet) for _ in range(length))
        if rng.random() < 0.3:
            word = "##" + word
        if word not in vocab:
            vocab[word] = len(vocab)
    return vocab


__all__ = [
    "load_vocab",
    "whitespace_tokenize",
    "BasicTokenizer",
    "WordpieceTokenizer",
    "BertTokenizer",
    "build_synthetic_vocab",
    "train_wordpiece_vocab",
    "SPECIAL_TOKENS",
]
