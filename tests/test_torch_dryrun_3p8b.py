"""rqvae_tpu_torch.tools.dryrun_3p8b on the CPU: the 3.8B geometry at its
full width (embed 2560, 40 heads, vocabulary 16384, 8x8x4 codes through
the RQ-VAE's codebooks) with the depth cut to 1 + 1 layers, split over 2
gloo ranks that the tool starts itself. Each rank holds its shard and no
more (the full model is never built), the ranks return the same codes,
and the zero weights give uniform logits, so the top-k 64 draw stays in
the vocabulary. On the card the tool runs at full depth
(chip_smoke.py phase 17 (b))."""

import torch

from rqvae_tpu_torch.models.rqtransformer.config import TransformerConfig
from rqvae_tpu_torch.models.rqtransformer.model import RQTransformer
from rqvae_tpu_torch.parallel.mesh import transformer_param_specs
from rqvae_tpu_torch.tools import dryrun_3p8b as DR

ARGS = ["--device", "cpu", "--body-layers", "1", "--head-layers", "1", "--timeout", "240"]


def test_each_rank_builds_its_shard_and_the_ranks_agree(capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks inherit it: one intra-op thread each
    summary = DR.main(ARGS)
    out = capsys.readouterr().out
    assert summary["ok"] and summary["codes_equal_across_ranks"] and summary["tp"] == 2
    assert out.count("# rank ") == 2 and out.strip().splitlines()[-1].startswith('{"ok": true')
    with torch.device("meta"):
        full = RQTransformer(TransformerConfig.create(DR.arch(DR.parse(ARGS))), device="meta")
    state = full.state_dict()
    specs = transformer_param_specs(state)
    want = sum(v.numel() // (1 if specs[k] is None else 2) for k, v in dict(full.named_parameters()).items())
    for r in summary["ranks"]:
        assert r["params_local"] == want < sum(p.numel() for p in full.parameters())
        assert r["codes_shape"] == [2, 8, 8, 4] and 0 <= r["codes_min"] <= r["codes_max"] < 16384
        assert r["backend"] == "gloo" and r["launches"] == 0  # the wrappers launch only for CUDA tensors


def test_the_arch_is_the_reference_flagship():
    a = DR.ARCH_3P8B
    assert (a["embed_dim"], a["body"]["n_layer"], a["head"]["n_layer"], a["body"]["block"]["n_head"]) == (2560, 42, 6, 40)
    assert (a["vocab_size"], a["block_size"], a["vocab_size_cond"]) == (16384, [8, 8, 4], 1000)
    args = DR.parse([])
    assert (args.tp, DR.BATCH, DR.TOP_K, args.random_init) == (2, 2, 64, False)
