"""Text tokenizer registry.

Port of rqvae_tpu/data/tokenizers.py (the reference's
txtimg_datasets/tokenizers/__init__.py:24-47): "simple", the CLIP BPE of
data/clip_tokenizer.py, and the HuggingFace BertWordPiece / ByteLevelBPE /
CharBPE 16k / 30k. The HuggingFace `tokenizers` package is imported only
when one of those is asked for, and its absence raises ImportError there.
Vocabulary files are found by clip_tokenizer._find (RQVAE_TPU_TOKENIZER_DIR,
or `vocab_dir`).
"""

from __future__ import annotations

from typing import Optional

from rqvae_tpu_torch.data.clip_tokenizer import SimpleTokenizer, _find

HF_TOKENIZERS = ("bert_huggingface", "gpt2_huggingface", "bpe16k_huggingface", "bpe30k_huggingface")


def create_tokenizer(tok_name: str, vocab_dir: Optional[str] = None, lowercase=True, dropout=None):
    if tok_name == "simple":
        return SimpleTokenizer(bpe_path=_find("bpe_simple_vocab_16e6.txt.gz", vocab_dir), lowercase=lowercase)
    if tok_name not in HF_TOKENIZERS:
        raise KeyError(f"unknown tokenizer {tok_name}")
    try:
        from tokenizers import BertWordPieceTokenizer, ByteLevelBPETokenizer, CharBPETokenizer
    except ImportError as e:
        raise ImportError(f"the tokenizer {tok_name!r} needs the HuggingFace 'tokenizers' package, which is not "
                          f"installed; 'simple' (the CLIP BPE) needs no package") from e
    if tok_name == "bert_huggingface":
        return BertWordPieceTokenizer(vocab=_find("bert-base-uncased-vocab.txt", vocab_dir), lowercase=lowercase)
    if tok_name == "gpt2_huggingface":
        return ByteLevelBPETokenizer.from_file(
            vocab_filename=_find("vocab.json", vocab_dir),
            merges_filename=_find("merges.txt", vocab_dir),
            lowercase=lowercase,
            dropout=dropout,
        )
    size = tok_name[3:6]  # bpe16k / bpe30k
    return CharBPETokenizer.from_file(
        vocab_filename=_find(f"bpe-{size}-vocab.json", vocab_dir),
        merges_filename=_find(f"bpe-{size}-merges.txt", vocab_dir),
        unk_token="[UNK]",
        lowercase=lowercase,
        dropout=dropout,
    )


def prepare_tokenizer(tokenizer, context_length: int):
    """[PAD] padding + truncation to context_length (the reference's cc3m.py:36-40)."""
    tokenizer.add_special_tokens(["[PAD]"])
    tokenizer.enable_padding(length=context_length, pad_id=tokenizer.token_to_id("[PAD]"))
    tokenizer.enable_truncation(max_length=context_length)
    return tokenizer
