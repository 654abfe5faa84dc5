"""Tokenizer shims.

The reference wraps NeMo-SP / HF / tiktoken / Gemini tokenizers behind a
uniform interface (`evaluate/data/ruler/tokenizer.py:25-35`). Here:

  * ``load_tokenizer(path)`` — HF AutoTokenizer from a local dir (no network).
  * ``ByteTokenizer`` — offline byte-level tokenizer for tests and synthetic
    benchmarks: encode = UTF-8 bytes (+0 reserved for pad/eos), decode =
    bytes back to text. vocab_size 258.
  * ``select_tokenizer(kind, path)`` — the reference's shim surface:
    ``hf`` / ``openai`` (tiktoken) / ``sp`` (raw SentencePiece model file,
    covering the NeMo-SP case without the NeMo dependency) / ``byte``.
    Gemini is an online API tokenizer and is out of scope in a zero-egress
    environment (``gemini`` raises with that explanation).

A copy of ``xkv_tpu/utils/tokenizer.py`` kept inside the port. The optional
packages (``transformers``, ``tiktoken``, ``sentencepiece``) are imported
where a tokenizer needs them; a missing one raises ``ImportError`` naming it.
"""

from __future__ import annotations

from typing import List


class ByteTokenizer:
    """Deterministic offline tokenizer: one token per UTF-8 byte.

    ids: 0 = pad, 1 = bos, 2 = eos, byte b -> 3 + b.
    """

    pad_token_id = 0
    bos_token_id = 1
    eos_token_id = 2
    vocab_size = 259
    name_or_path = "byte-tokenizer"

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids = [3 + b for b in text.encode("utf-8")]
        if add_special_tokens:
            ids = [self.bos_token_id] + ids
        return ids

    def __call__(self, text: str, **kw):
        return {"input_ids": self.encode(text, kw.get("add_special_tokens", False))}

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        # ids outside 3..258 are not bytes (specials below, and models
        # with a larger vocab — e.g. the vocab-1024 study model — may emit
        # private ids above); drop them like other tokenizers drop
        # unknown pieces.
        data = bytes(int(i) - 3 for i in ids if 3 <= int(i) <= 258)
        return data.decode("utf-8", errors="ignore")


class TiktokenTokenizer:
    """tiktoken-backed tokenizer (reference ``OpenAITokenizer``,
    `evaluate/data/ruler/tokenizer.py:77-91`). Works offline for encodings
    whose BPE files are in the local tiktoken cache."""

    pad_token_id = 0
    bos_token_id = None
    eos_token_id = None

    def __init__(self, encoding: str = "cl100k_base"):
        try:
            import tiktoken
        except ImportError as e:
            raise ImportError(
                "the tiktoken backend needs the 'tiktoken' package") from e

        self._enc = tiktoken.get_encoding(encoding)
        self.name_or_path = f"tiktoken:{encoding}"
        self.vocab_size = self._enc.n_vocab

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        return self._enc.encode(text)

    def __call__(self, text: str, **kw):
        return {"input_ids": self.encode(text)}

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self._enc.decode([int(i) for i in ids])


class SentencePieceTokenizer:
    """Raw SentencePiece ``.model``-file tokenizer — covers the reference's
    NeMo-SP backend (`evaluate/data/ruler/tokenizer.py:38-52`) without the
    NeMo dependency. Requires the ``sentencepiece`` package (gated)."""

    pad_token_id = 0

    def __init__(self, model_path: str):
        try:
            import sentencepiece as spm
        except ImportError as e:
            raise ImportError(
                "SentencePiece backend needs the 'sentencepiece' package; "
                "use kind='hf' (HF tokenizers bundle their own SP runtime)"
            ) from e
        self._sp = spm.SentencePieceProcessor(model_file=model_path)
        self.name_or_path = model_path
        self.vocab_size = self._sp.vocab_size()
        self.bos_token_id = self._sp.bos_id()
        self.eos_token_id = self._sp.eos_id()

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids = self._sp.encode(text)
        if add_special_tokens and self.bos_token_id >= 0:
            ids = [self.bos_token_id] + ids
        return ids

    def __call__(self, text: str, **kw):
        return {"input_ids": self.encode(text, kw.get("add_special_tokens", False))}

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self._sp.decode([int(i) for i in ids])


def select_tokenizer(kind: str, name_or_path: str = ""):
    """Uniform tokenizer selection (reference `tokenizer.py:25-35`).

    kind: ``hf`` | ``openai``/``tiktoken`` | ``sp``/``nemo`` | ``byte``.
    """
    if kind == "hf":
        return load_tokenizer(name_or_path)
    if kind in ("openai", "tiktoken"):
        return TiktokenTokenizer(name_or_path or "cl100k_base")
    if kind in ("sp", "nemo", "sentencepiece"):
        return SentencePieceTokenizer(name_or_path)
    if kind in ("byte", "bytes"):
        return ByteTokenizer()
    if kind == "gemini":
        raise ValueError(
            "the Gemini tokenizer is an online API (reference tokenizer.py:94-107); "
            "not supported in a zero-egress environment"
        )
    raise ValueError(f"Unknown tokenizer kind {kind!r}")


def load_tokenizer(name_or_path: str):
    if name_or_path in ("byte", "bytes", "byte-tokenizer"):
        return ByteTokenizer()
    if name_or_path.startswith("tiktoken:"):
        return TiktokenTokenizer(name_or_path.split(":", 1)[1])
    if name_or_path.endswith(".model"):
        return SentencePieceTokenizer(name_or_path)
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            f"loading the HF tokenizer of {name_or_path!r} needs the "
            "'transformers' package; pass 'byte', 'tiktoken:<encoding>' or a "
            "SentencePiece '.model' file otherwise") from e

    return AutoTokenizer.from_pretrained(name_or_path, trust_remote_code=True)
