"""Deterministic word-hash id for the offline stand-in tokenizer: the
port's own copy of the JAX package's ``utils/hash_tok.py`` (md5[:8] mod the
non-reserved vocab, shifted past the reserved special ids), so both packages
tokenize a text to the same ids."""

import hashlib


def hash_word_id(word: str, vocab_size: int, reserved: int) -> int:
    """Stable id in [reserved, vocab_size) for ``word``."""
    h = int(hashlib.md5(word.encode()).hexdigest()[:8], 16)
    return reserved + h % (vocab_size - reserved)
