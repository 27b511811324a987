"""The launch plan of csrc/decode_attention_tma.cu (#1 decode_attention_update
and #4 decode_attention_q8_update, each batch row's window staged through
shared memory by bulk async copies), and the sampler's dispatch to the
update wrappers.

The kernel runs only on the card (chip_smoke.py holds it against its plain
version there). Here ops/attention_kernel.py::attention_plan, the plan the
wrappers launch, is checked on the host at every batch the port runs (1, 8,
37, 100, 500), head sizes 64 and 104, bf16 and int8 caches, and windows 0,
1, 15, 16, 63, 64, 129 and the cap: through AttentionPlan's restatement of
the kernel's work split and copy loop, every (batch row, head, window row)
is attended once, every window row's group columns are copied once per
pass, each head's slice of row cur_len is written once, every bulk copy is
16-byte aligned and sized and lies inside its ring stage, and shared memory
stays within a CTA's limit. Shapes the kernel does not take raise
ValueError before the kernel library or the device is asked. The dispatch
test spies on the wrappers while stack_step_unrolled takes body and head
steps on the CPU (as tests/test_torch_q8.py spies on the dense pair).
"""

import numpy as np
import pytest
import torch

from rqvae_tpu_torch.models.rqtransformer import model as TM
from rqvae_tpu_torch.ops import attention_kernel as AK
from rqvae_tpu_torch.ops import decode_layer_kernel as DK
from test_torch_rqtransformer import build_pair

BATCHES = (1, 8, 37, 100, 500)
WIDTHS = {64: (1536, 24), 104: (1664, 16)}  # head size -> (C, n_head) of the models that run it
WINDOWS = (0, 1, 15, 16, 63, 64, 129, AK.TMA_MAX_WINDOW)


def _check_copies(plan, cta, n_valid, T):
    """CTA `cta`'s bulk copies, unit after unit: each 16-byte aligned and
    sized inside its ring stage, the chunks numbered on without a gap, each
    chunk the bytes of its rows; per unit and pass, every (head of the
    unit's group, window row) copied once and nothing else."""
    row_bytes, head_bytes = plan.C * plan.eb, plan.hs * plan.eb
    stage = -(-plan.rows * plan.piece // 128) * 128
    units = list(plan.units(cta))
    nck = -(-n_valid // plan.rows)
    chunk_bytes, counts = {}, {}
    for c, u, which, src, dst, nbytes in plan.copies(cta, n_valid, T):
        assert src % 16 == 0 and dst % 16 == 0 and nbytes % 16 == 0 and nbytes > 0
        s0 = (c % plan.stages) * stage
        assert s0 <= dst and dst + nbytes <= s0 + plan.rows * plan.piece
        assert u == units[c // (2 * nck)] and which == ("k" if c % (2 * nck) < nck else "v")
        chunk_bytes[c] = chunk_bytes.get(c, 0) + nbytes
        b, g = divmod(u, plan.groups)
        count = counts.setdefault((u, which), np.zeros((plan.n_head, T), np.int64))
        row, col = divmod(src - b * T * row_bytes, row_bytes)
        if nbytes >= row_bytes:  # whole rows: the group is every head
            assert col == 0 and nbytes % row_bytes == 0
            count[:, row:row + nbytes // row_bytes] += 1
        else:
            assert col % head_bytes == 0 and nbytes % head_bytes == 0 and col + nbytes <= row_bytes
            count[col // head_bytes:(col + nbytes) // head_bytes, row] += 1
    assert sorted(chunk_bytes) == list(range(len(units) * 2 * nck))
    for c, nbytes in chunk_bytes.items():
        k = c % (2 * nck) % nck
        assert nbytes == min(plan.rows, n_valid - k * plan.rows) * plan.piece
    for u in units if nck else []:
        g = u % plan.groups
        want = np.zeros((plan.n_head, T), np.int64)
        want[g * plan.hpc:(g + 1) * plan.hpc, :n_valid] = 1
        assert (counts[(u, "k")] == want).all() and (counts[(u, "v")] == want).all()


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("hs", sorted(WIDTHS))
@pytest.mark.parametrize("B", BATCHES)
def test_attention_plan_covers_each_row_and_head_once(B, hs, q8, window):
    """Units (b, g) go to the CTAs one each and the groups tile the heads,
    so every (b, head, window row) is attended once and each (b, head)
    slice of row cur_len is written once (by the CTA of its unit); the
    copies of the first and the last CTA hold to _check_copies; shared
    memory within a CTA's limit."""
    C, nh = WIDTHS[hs]
    plan = AK.attention_plan(B, C, nh, window, q8)
    assert (plan.B, plan.C, plan.n_head, plan.window, plan.eb) == (B, C, nh, window, 1 if q8 else 2)
    assert nh % plan.groups == 0 and 1 <= plan.ctas <= B * plan.groups
    assert plan.hpc * AK._team_lanes(hs) * plan.n_sub <= AK.TMA_THREADS and plan.n_sub >= 1
    assert 1 <= plan.rows and 1 <= plan.stages <= AK.TMA_MAX_STAGES
    assert plan.smem == AK._tma_smem(plan.piece, plan.hpc, window, plan.rows, plan.stages, q8) <= DK.SMEM_LIMIT
    assert not q8 or window * plan.hpc <= AK.TMA_MAX_SCALES * AK.TMA_THREADS
    assert (C * plan.eb) % 16 == 0 and plan.piece % 16 == 0
    heads = np.zeros((B, nh), np.int64)  # each unit's heads, over the CTAs
    for cta in range(plan.ctas):
        for u in plan.units(cta):
            b, g = divmod(u, plan.groups)
            heads[b, g * plan.hpc:(g + 1) * plan.hpc] += 1
    assert (heads == 1).all()  # attended over the whole window, and row cur_len written, once per (b, head)
    T = window + 1  # row cur_len = window lies past the window
    for n_valid in sorted({window, window // 2 + (window > 0)}):
        for cta in sorted({0, plan.ctas - 1}):
            _check_copies(plan, cta, n_valid, T)


@pytest.mark.parametrize("B", BATCHES)
def test_attention_plan_fills_the_card(B):
    """Of the groups whose teams fit, whose row piece is a 16-byte multiple
    and at least TMA_MIN_PIECE bytes and (int8) whose window's scales the
    threads hold: the fewest that give every SM a unit, else the most; as
    many CTAs as units, up to TMA_CTAS_PER_SM per SM."""
    slots = AK.TMA_CTAS_PER_SM * DK.SMS
    for hs, (C, nh) in WIDTHS.items():
        for q8 in (False, True):
            eb = 1 if q8 else 2
            valid = [G for G in range(1, nh + 1) if nh % G == 0 and (nh // G * hs * eb) % 16 == 0
                     and nh // G * AK._team_lanes(hs) <= AK.TMA_THREADS
                     and (not q8 or 64 * nh // G <= AK.TMA_MAX_SCALES * AK.TMA_THREADS)]
            wide = [G for G in valid if nh // G * hs * eb >= AK.TMA_MIN_PIECE]
            want = next((G for G in wide if B * G >= DK.SMS), wide[-1])
            plan = AK.attention_plan(B, C, nh, 64, q8)
            assert (plan.groups, plan.ctas) == (want, min(B * want, slots))


def test_attention_plan_pins_the_split_and_is_device_independent():
    plan = AK.attention_plan(100, 1536, 24, 64, True, groups=1)
    assert plan.groups == 1 and plan.piece == 1536 and plan.n_sub == 1
    assert plan.ctas == 100
    small = AK.attention_plan(100, 1536, 24, 64, False, sms=66)
    assert small.ctas <= AK.TMA_CTAS_PER_SM * 66 and small.groups <= AK.attention_plan(100, 1536, 24, 64,
                                                                                         False).groups


@pytest.mark.parametrize("B,C,nh,window,q8,match", [
    (100, 1560, 15, 64, True, "16-byte multiple"),  # int8 at head size 104, an odd head count: 1560 B a row
    (100, 1536, 16, 64, False, "head sizes"),  # head size 96
    (100, 1536, 24, AK.TMA_MAX_WINDOW + 1, False, "window"),
    (0, 1536, 24, 64, True, "B in 1..65535"),
    (70000, 1536, 24, 64, False, "B in 1..65535"),
])
def test_attention_plan_refuses_other_shapes_before_the_library(B, C, nh, window, q8, match, monkeypatch):
    def asked(*args, **kwargs):
        raise AssertionError("the kernel library or the device was asked")

    monkeypatch.setattr(AK._build, "library", asked)
    monkeypatch.setattr(torch.cuda, "get_device_properties", asked)
    with pytest.raises(ValueError, match=match):
        AK.attention_plan(B, C, nh, window, q8)
    with pytest.raises(ValueError, match=match):
        AK._device_attention_plan(B, C, nh, window, q8, torch.device("cuda", 0))


def test_bf16_head_size_104_takes_an_odd_head_count():
    plan = AK.attention_plan(37, 1560, 15, 64, False)
    assert plan.piece % 16 == 0 and (1560 * 2) % 16 == 0


def test_first_design_baselines_need_a_card():
    q = torch.zeros(2, 128, dtype=torch.bfloat16)
    c = torch.zeros(2, 8, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="decode_attention_update_v1: no kernel for device cpu"):
        AK.decode_attention_update_v1(q, q, q, c, c, 0, 2)
    i8 = torch.zeros(2, 8, 128, dtype=torch.int8)
    s = torch.zeros(2, 8, 2, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="decode_attention_q8_update_v1: no kernel for device cpu"):
        AK.decode_attention_q8_update_v1(q, q, q, i8, s, i8, s, 0, 2)
    assert AK.decode_attention_update_v1.launches == 0 and AK.decode_attention_q8_update_v1.launches == 0


ATTN_FNS = ("decode_attention_update", "decode_attention_update_plain", "decode_attention_update_v1",
            "decode_attention_q8_update", "decode_attention_q8_update_plain", "decode_attention_q8_update_v1")
# (stack, int8 KV cache, kernels, S): the attention functions each layer of
# the step calls; on the CPU a wrapper calls its plain version, so the
# wrappers' calls show in the plain counts too; the _v1 baselines never
ATTN_CASES = {
    "body_bf16": ("body", False, True, 1, {"decode_attention_update": 1, "decode_attention_update_plain": 1}),
    "body_kv_q8": ("body", True, True, 1, {"decode_attention_q8_update": 1, "decode_attention_q8_update_plain": 1}),
    "body_bf16_plain": ("body", False, False, 1, {"decode_attention_update_plain": 1}),
    "body_kv_q8_plain": ("body", True, False, 1, {"decode_attention_q8_update_plain": 1}),
    "body_prefill": ("body", False, True, 3, {}),
    "head_bf16": ("head", False, True, 1, {"decode_attention_update_plain": 1}),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_sampler_step_reaches_the_update_wrappers(case, monkeypatch):
    """A body S == 1 step with kernels reaches decode_attention_update (bf16
    cache) or decode_attention_q8_update (int8 cache) once per layer, whose
    CUDA branch launches csrc/decode_attention_tma.cu; a head step (short
    caches) and kernels=False take the plain versions, a prefill neither;
    the _v1 baselines are never called. The wrappers' launch counters do
    not move on the CPU."""
    role, q8, kernels, S, want = ATTN_CASES[case]
    _, _, _, _, model, _ = build_pair()
    wrappers = [AK.decode_attention_update, AK.decode_attention_q8_update]
    before = [fn.launches for fn in wrappers]
    calls = dict.fromkeys(ATTN_FNS, 0)
    for name in ATTN_FNS:
        def spy(*args, _fn=getattr(AK, name), _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(AK, name, spy)
    stack = model.body_transformer if role == "body" else model.head_transformer
    cfg = model.config.body if role == "body" else model.config.head
    B, T, C = 3, 8, cfg.embed_dim
    x = torch.from_numpy(np.random.RandomState(11).standard_normal((B, S, C)).astype(np.float32))
    caches = (TM.init_unrolled_kv_cache_q8(cfg, B, T, "cpu") if q8
              else TM.init_unrolled_kv_cache(cfg, B, T, torch.float32, "cpu"))
    TM.stack_step_unrolled(stack, x, caches, 2, kernels=kernels)
    n = len(stack.blocks)
    assert calls == {name: want.get(name, 0) * n for name in ATTN_FNS}
    assert [fn.launches for fn in wrappers] == before
