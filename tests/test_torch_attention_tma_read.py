"""The read-only launch plan of csrc/decode_attention_tma.cu (#10
decode_attention, #12 decode_attention_stacked and #11 decode_attention_q8),
and the stacked sampler's dispatch to decode_attention_stacked.

The kernel runs only on the card (chip_smoke.py holds it against its plain
version there). Here ops/attention_kernel.py::attention_plan with
write=False, the plan the read-only wrappers launch, is checked on the host
at every batch the port runs (1, 8, 37, 100, 500), head sizes 64 and 104,
bf16 and int8 caches, and windows 0, 1, 63, 64, 128, 256 and 257 (the f16
stacked sampler's T), with cur_len up to and including T: through
AttentionPlan's restatement of the kernel's work split and copy loop, every
(batch row, head, row < n_valid) is attended once, every bulk copy is
16-byte aligned and sized, lies inside its ring stage and inside the layer's
[B, T, C] slab of a stack with T = 257, and nothing is written. The same
holds at the long windows of the f8 stacked sampler (T = cond_len + 1024)
and beyond, up to what a CTA's shared memory holds. Shapes the kernel does
not take raise ValueError before the kernel library or the device is
asked. The dispatch test spies on the wrappers while stack_step
takes body and head steps on the CPU.
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
WINDOWS = (0, 1, 63, 64, 128, 256, 257)
T_STACK = 257  # the f16 stacked sampler's cache rows: the condition and 256 positions
# the read-only form's long windows: the f8 stacked sampler's T = cond_len +
# 32 x 32 (cond_len 1, cc3m's 32), 2048 and 4096 rows
LONG_WINDOWS = (513, 1025, 1056, 2048, 4096)


def _attended(plan, n_valid, T, ctas):
    """(copies of rows [n_head, T] per pass and batch row, over the given
    CTAs) after checking each of their bulk copies: 16-byte aligned and
    sized, inside its ring stage and inside the [B, T, C] slab; the chunks
    of each CTA numbered on without a gap, each the bytes of its rows."""
    row_bytes, head_bytes = plan.C * plan.eb, plan.hs * plan.eb
    stage = -(-plan.rows * plan.piece // 128) * 128
    count = {"k": {}, "v": {}}
    for cta in ctas:
        units = list(plan.units(cta))
        nck = -(-n_valid // plan.rows)
        chunk_bytes = {}
        for c, u, which, src, dst, nbytes in plan.copies(cta, n_valid, T):
            assert src % 16 == 0 and dst % 16 == 0 and nbytes % 16 == 0 and nbytes > 0
            assert 0 <= src and src + nbytes <= plan.B * T * row_bytes  # inside the layer's slab
            s0 = (c % plan.stages) * stage
            assert s0 <= dst and dst + nbytes <= s0 + plan.rows * plan.piece
            assert u == units[c // (2 * nck)] and which == ("k" if c % (2 * nck) < nck else "v")
            chunk_bytes[c] = chunk_bytes.get(c, 0) + nbytes
            b, row_off = divmod(src, T * row_bytes)
            assert b == u // plan.groups
            row, col = divmod(row_off, row_bytes)
            rows = count[which].setdefault(b, np.zeros((plan.n_head, T), np.int64))
            if nbytes >= row_bytes:  # whole rows: the group is every head
                assert col == 0 and nbytes % row_bytes == 0
                rows[:, row:row + nbytes // row_bytes] += 1
            else:
                assert col % head_bytes == 0 and nbytes % head_bytes == 0 and col + nbytes <= row_bytes
                rows[col // head_bytes:(col + nbytes) // head_bytes, row] += 1
        assert sorted(chunk_bytes) == list(range(len(units) * 2 * nck))
        for c, nbytes in chunk_bytes.items():
            k = c % (2 * nck) % nck
            assert nbytes == min(plan.rows, n_valid - k * plan.rows) * plan.piece
    return count


def _check_read_plan(plan, B, C, nh, window, q8):
    assert (plan.B, plan.C, plan.n_head, plan.window, plan.eb) == (B, C, nh, window, 1 if q8 else 2)
    assert not plan.write and nh % plan.groups == 0
    assert 1 <= plan.ctas <= B * plan.groups
    assert plan.hpc * AK._team_lanes(plan.hs) * plan.n_sub <= AK.TMA_THREADS and plan.n_sub >= 1
    assert 1 <= plan.rows and 1 <= plan.stages <= AK.TMA_MAX_STAGES
    assert plan.smem == AK._tma_smem(plan.piece, plan.hpc, window, plan.rows, plan.stages, q8)
    assert plan.smem <= DK.SMEM_LIMIT
    assert not q8 or window * plan.hpc <= AK.TMA_MAX_SCALES * AK.TMA_THREADS
    assert (C * plan.eb) % 16 == 0 and plan.piece % 16 == 0
    assert all(plan.writes(cta) == [] for cta in range(plan.ctas))  # read-only: nothing is written


def _n_valids(window, T=T_STACK):
    """n_valid = min(cur_len, window) over cur_len 0, half the window, the
    window and T (cur_len == T: the read-only form reads every row)."""
    return sorted({min(cur, window) for cur in (0, window // 2 + (window > 0), window, T)})


def _check_coverage(plan, B, nh, window, T):
    """Units (b, g) go to the CTAs one each and the groups tile the heads;
    the copies of the first and the last CTA hold to _attended, each of
    their (batch row, head of the unit's group, row < n_valid) copied once
    per pass and nothing else."""
    heads = np.zeros((B, nh), np.int64)
    for cta in range(plan.ctas):
        for u in plan.units(cta):
            b, g = divmod(u, plan.groups)
            heads[b, g * plan.hpc:(g + 1) * plan.hpc] += 1
    assert (heads == 1).all()
    for n_valid in _n_valids(window, T):
        for cta in sorted({0, plan.ctas - 1}):
            count = _attended(plan, n_valid, T, [cta])
            want = {}
            for u in plan.units(cta):
                b, g = divmod(u, plan.groups)
                want.setdefault(b, np.zeros((nh, T), np.int64))[g * plan.hpc:(g + 1) * plan.hpc, :n_valid] = 1
            want = {b: rows for b, rows in want.items() if n_valid}  # no row attended: no copy
            for which in ("k", "v"):
                assert count[which].keys() == want.keys()
                assert all((count[which][b] == rows).all() for b, rows in want.items())


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("hs", sorted(WIDTHS))
@pytest.mark.parametrize("B", BATCHES)
def test_read_plan_attends_each_row_and_head_once(B, hs, q8, window):
    """_check_coverage at the f16 stacked sampler's T; shared memory
    within a CTA's limit; nothing written."""
    C, nh = WIDTHS[hs]
    plan = AK.attention_plan(B, C, nh, window, q8, write=False)
    _check_read_plan(plan, B, C, nh, window, q8)
    _check_coverage(plan, B, nh, window, T_STACK)


@pytest.mark.parametrize("T", LONG_WINDOWS)
@pytest.mark.parametrize("hs", sorted(WIDTHS))
@pytest.mark.parametrize("B", BATCHES)
def test_read_plan_takes_the_long_windows(B, hs, T):
    """The bf16 read-only plan of a window past the update form's
    TMA_MAX_WINDOW (the f8 stacked sampler's T of 1025 and 1056 rows, and
    beyond): _check_coverage with cur_len up to T; its window's scores and
    at least one ring stage within a CTA's shared memory; where they leave
    no room for TMA_CTAS_PER_SM CTAs an SM, one CTA an SM."""
    C, nh = WIDTHS[hs]
    plan = AK.attention_plan(B, C, nh, T, False, write=False)
    _check_read_plan(plan, B, C, nh, T, False)
    assert 1 <= plan.stages <= AK.TMA_READ_STAGES
    if plan.smem > AK.SM_SMEM // AK.TMA_CTAS_PER_SM - 1024:
        assert plan.ctas <= DK.SMS
    _check_coverage(plan, B, nh, T, T)


@pytest.mark.parametrize("hs,T", [(64, 1024), (64, 1056), (64, 2048), (104, 1024)])
def test_int8_read_plan_takes_the_long_windows_its_threads_hold(hs, T):
    """The int8 read-only plan past TMA_MAX_WINDOW: the groups narrow until
    a unit's window x hpc scales fit the threads (TMA_MAX_SCALES x
    TMA_THREADS); at head size 104 no even head count holds more than 1024
    rows' scales, so 1025 rows are refused before the library."""
    C, nh = WIDTHS[hs]
    for B in (37, 100):
        plan = AK.attention_plan(B, C, nh, T, True, write=False)
        _check_read_plan(plan, B, C, nh, T, True)
        _check_coverage(plan, B, nh, T, T)
    if hs == 104:
        with pytest.raises(ValueError, match="scales fit"):
            AK.attention_plan(100, C, nh, T + 1, True, write=False)


@pytest.mark.parametrize("B", BATCHES)
def test_read_plan_fills_the_card(B):
    """The read-only plan picks its head groups and CTAs as the update plan
    does: of the groups whose teams fit, whose row piece is a 16-byte
    multiple and at least TMA_MIN_PIECE bytes and (int8) whose window's
    scales the threads hold, the fewest that give every SM a unit, else the
    most; no window split; as many CTAs as units, up to TMA_CTAS_PER_SM per
    SM; the plan sized on the stacked sampler's T. Its ring: the update
    plan's at int8, at most TMA_READ_STAGES stages at bf16."""
    for hs, (C, nh) in WIDTHS.items():
        for q8, window in ((False, T_STACK), (True, 64)):
            plan = AK.attention_plan(B, C, nh, window, q8, write=False)
            update = AK.attention_plan(B, C, nh, window, q8)
            assert (plan.groups, plan.ctas) == (update.groups, update.ctas)
            assert (plan.rows, plan.stages) == (update.rows, update.stages if q8 else
                                                min(update.stages, AK.TMA_READ_STAGES))


@pytest.mark.parametrize("B,C,nh,window,q8,match", [
    (100, 1560, 15, 64, True, "16-byte multiple"),  # int8 at head size 104, an odd head count: 1560 B a row
    (100, 1536, 16, 64, False, "head sizes"),  # head size 96
    (100, 1536, 24, -1, False, "window of 0 or more"),
    (100, 1536, 24, 100_000, False, "bytes of shared memory"),  # no group's scores fit
    (100, 1536, 24, 2049, True, "scales fit"),  # more than 2048 rows' scales even at one head a group
    (0, 1536, 24, 64, True, "B in 1..65535"),
])
def test_read_plan_refuses_other_shapes_before_the_library(B, C, nh, window, q8, match, monkeypatch):
    def asked(*args, **kwargs):
        raise AssertionError("the kernel library or the device was asked")

    monkeypatch.setattr(AK._build, "library", asked)
    monkeypatch.setattr(torch.cuda, "get_device_properties", asked)
    with pytest.raises(ValueError, match=match):
        AK.attention_plan(B, C, nh, window, q8, write=False)
    with pytest.raises(ValueError, match=match):
        AK._device_attention_plan(B, C, nh, window, q8, torch.device("cuda", 0), write=False)


def test_read_plan_refuses_more_int8_scales_than_its_threads_hold():
    """window x hpc <= TMA_MAX_SCALES x TMA_THREADS (2048): one group of 24
    heads holds 85 rows' scales; a split into more groups takes the rest."""
    assert AK.TMA_MAX_SCALES * AK.TMA_THREADS == 2048
    AK.attention_plan(100, 1536, 24, 85, True, groups=1, write=False)
    with pytest.raises(ValueError, match="at groups=1 .* scales fit"):
        AK.attention_plan(100, 1536, 24, 86, True, groups=1, write=False)
    plan = AK.attention_plan(100, 1536, 24, 1056, True, write=False)
    assert 1056 * plan.hpc <= 2048


def test_read_plans_are_cached_apart_from_the_update_plans(monkeypatch):
    """One cached plan per (B, C, n_head, window, q8, write, device): the
    read-only and the update plan of one shape are two entries."""
    props = type("Props", (), {"multi_processor_count": DK.SMS})()
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: props)
    monkeypatch.setattr(AK, "_tma_plans", {})
    dev = torch.device("cuda", 0)
    read = AK._device_attention_plan(100, 1536, 24, T_STACK, False, dev, write=False)
    update = AK._device_attention_plan(100, 1536, 24, T_STACK, False, dev)
    assert not read.write and update.write and read is not update
    assert AK._device_attention_plan(100, 1536, 24, T_STACK, False, dev, write=False) is read
    assert set(AK._tma_plans) == {(100, 1536, 24, T_STACK, False, w, 0) for w in (False, True)}


@pytest.mark.parametrize("hs", sorted(WIDTHS))
def test_a_stack_layer_view_starts_on_16_bytes(hs):
    """The stacked wrapper passes k_cache[layer] (no copy): the layer's base
    pointer lies B T C x 2 bytes on, a 16-byte multiple at every head size
    the kernel serves; a view off 16 bytes is refused."""
    C, nh = WIDTHS[hs]
    stack = torch.zeros(3, 2, T_STACK, C, dtype=torch.bfloat16)
    for layer in range(3):
        assert stack[layer].data_ptr() % 16 == 0
        AK._check_tma("decode_attention", stack[layer])
    flat = torch.zeros(2 * T_STACK * C + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte boundary"):
        AK._check_tma("decode_attention", flat[1:].view(2, T_STACK, C))


def test_read_only_first_designs_need_a_card():
    q = torch.zeros(2, 128, dtype=torch.bfloat16)
    c = torch.zeros(2, 8, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="decode_attention_v1: no kernel for device cpu"):
        AK.decode_attention_v1(q, q, q, c, c, 8, 2)
    i8 = torch.zeros(2, 8, 128, dtype=torch.int8)
    s = torch.zeros(2, 8, 2, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="decode_attention_q8_v1: no kernel for device cpu"):
        AK.decode_attention_q8_v1(q, q, q, i8, s, i8, s, 8, 2)
    assert AK.decode_attention_v1.launches == 0 and AK.decode_attention_q8_v1.launches == 0


def test_read_only_wrappers_never_take_the_plain_version_off_the_cpu():
    """Only a CPU tensor takes the plain version: a tensor on any other
    device is refused (on CUDA the wrappers launch the kernel or raise)."""
    def z(*shape, dtype=torch.bfloat16):
        return torch.zeros(*shape, dtype=dtype, device="meta")

    x = z(2, 128)
    for fn, caches in ((AK.decode_attention, (z(2, 8, 128), z(2, 8, 128))),
                       (AK.decode_attention_q8, (z(2, 8, 128, dtype=torch.int8), z(2, 8, 2),
                                                 z(2, 8, 128, dtype=torch.int8), z(2, 8, 2)))):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            fn(x, x, x, *caches, 8, 2)


STACK_FNS = ("decode_attention_stacked", "decode_attention_stacked_plain", "decode_attention",
             "decode_attention_plain", "decode_attention_v1")


@pytest.mark.parametrize("role,kernels", [("body", True), ("head", True), ("body", False)])
def test_stack_step_reaches_the_stacked_wrapper_for_the_body_alone(role, kernels, monkeypatch):
    """A body S == 1 step of stack_step with kernels reaches
    decode_attention_stacked once per layer (whose CUDA branch launches
    rq_attention_tma_read on the layer's view; on the CPU it takes the
    plain version, which shows in the plain count too); a head step and
    kernels=False take decode_attention_stacked_plain alone; the _v1
    baseline never runs. The launch counters do not move on the CPU."""
    _, _, _, _, model, _ = build_pair()
    wrappers = (AK.decode_attention_stacked, AK.decode_attention)
    before = [fn.launches for fn in wrappers]
    calls = dict.fromkeys(STACK_FNS, 0)
    for name in STACK_FNS:
        def spy(*args, _fn=getattr(AK, name), _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(AK, name, spy)
    stack = model.body_transformer if role == "body" else model.head_transformer
    B, T, C = 3, 9, stack.cfg.embed_dim
    cache = TM.init_kv_cache(stack.cfg, B, T, torch.float32, "cpu")
    x = torch.from_numpy(np.random.RandomState(5).standard_normal((B, 1, C)).astype(np.float32))
    TM.stack_step(stack, x, cache, 4, kernels=kernels)
    n = len(stack.blocks)
    kernel = role == "body" and kernels
    assert calls == {"decode_attention_stacked": n if kernel else 0, "decode_attention_stacked_plain": n,
                     "decode_attention": 0, "decode_attention_plain": n, "decode_attention_v1": 0}
    assert [fn.launches for fn in wrappers] == before


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
def test_wrapper_launches_the_read_only_plan_sized_on_T(q8, monkeypatch):
    """The wrappers' CUDA branch (_run_tma) asks for the read-only plan of
    the layer's shape, its window T (257 for the stacked sampler's stack,
    whatever cur_len), int8 by the cache's dtype, and launches the
    read-only entry once with cur_len; a view of a stack's layer passes
    its own base pointer. The launch is captured here: the kernel needs a
    card."""
    props = type("Props", (), {"multi_processor_count": DK.SMS})()
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: props)
    monkeypatch.setattr(AK, "_tma_plans", {})
    launched = []
    monkeypatch.setattr(AK, "_launch_tma", lambda entry, plan, q, tensors, T, cur_len: launched.append(
        (entry, plan, [t.data_ptr() for t in tensors], T, cur_len)))
    B, (C, nh) = 100, WIDTHS[64]
    q = torch.zeros(B, C, dtype=torch.bfloat16)
    dtype = torch.int8 if q8 else torch.bfloat16
    stack = torch.zeros(2, B, T_STACK, C, dtype=dtype)
    caches = (stack[1], torch.zeros(B, T_STACK, nh), stack[0], torch.zeros(B, T_STACK, nh)) if q8 else (stack[1],
                                                                                                        stack[0])
    entry = "rq_attention_tma_q8_read" if q8 else "rq_attention_tma_read"
    for cur_len in (0, 256, T_STACK):
        AK._run_tma("decode_attention", entry, (q, q, q, *caches), cur_len, nh, None)
    assert [(e, T, cur) for e, _, _, T, cur in launched] == [(entry, T_STACK, c) for c in (0, 256, T_STACK)]
    plans = {id(plan) for _, plan, _, _, _ in launched}
    assert len(plans) == 1  # one cached plan for every cur_len
    plan = launched[0][1]
    assert plan == AK.attention_plan(B, C, nh, T_STACK, q8, write=False)
    assert launched[0][2][3] == stack.data_ptr() + B * T_STACK * C * stack.element_size()
