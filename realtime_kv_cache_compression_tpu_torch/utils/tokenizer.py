"""Tokenizer interface: HF AutoTokenizer when a checkpoint is available
locally, the byte-level `ByteTokenizer` otherwise.

A copy of the JAX package's `utils/tokenizer.py` (framework-free; that
package's `utils/__init__.py` imports JAX, so the port keeps its own).
Any object with encode/decode serves; `ByteTokenizer` keeps the serving
stack runnable and deterministic without a downloaded tokenizer.
"""

from __future__ import annotations

from typing import List, Optional


class ByteTokenizer:
    """UTF-8 byte tokenizer: ids 0..255 are bytes, 256 = BOS, 257 = EOS."""

    vocab_size = 258
    bos_token_id = 256
    eos_token_id = 257

    def encode(self, text: str, max_length: Optional[int] = None,
               add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [self.bos_token_id] + ids
        if max_length is not None and len(ids) > max_length:
            ids = ids[:max_length]
        return ids

    _SPECIALS = {256: "<s>", 257: "</s>"}

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        # Only byte ids enter bytes(); specials render as explicit strings
        # when requested (ids >= 256 would make bytes() raise ValueError).
        pieces: List[str] = []
        run: List[int] = []

        def flush():
            if run:
                pieces.append(bytes(run).decode("utf-8", errors="ignore"))
                run.clear()

        for i in ids:
            i = int(i)
            if 0 <= i < 256:
                run.append(i)
            elif not skip_special_tokens:
                flush()
                pieces.append(self._SPECIALS.get(i, f"<unk:{i}>"))
        flush()
        return "".join(pieces)


def load_tokenizer(model_name_or_path: Optional[str] = None):
    """HF tokenizer if loadable locally, else ByteTokenizer."""
    if model_name_or_path:
        try:
            from transformers import AutoTokenizer

            return AutoTokenizer.from_pretrained(model_name_or_path,
                                                 local_files_only=True)
        except Exception:
            pass
    return ByteTokenizer()


def encode_ids(tokenizer, text: str, max_length: Optional[int] = None):
    """Uniform encode across HF tokenizers and ByteTokenizer."""
    if isinstance(tokenizer, ByteTokenizer):
        return tokenizer.encode(text, max_length=max_length)
    out = tokenizer(text, truncation=max_length is not None,
                    max_length=max_length)["input_ids"]
    return out


def decode_ids(tokenizer, ids) -> str:
    return tokenizer.decode(ids, skip_special_tokens=True)
