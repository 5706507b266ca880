"""On a CUDA card: the port's attention kernels against their plain
versions, at shapes and positions the serving path's check in
``chip_smoke.py`` does not take (S != T, groups 1 and 3, non-causal, the
decode splits' edges, more than 32 splits, pos < 0, an f32 query over f32
and bf16 caches):
the tensor-core flash kernel (bf16, hd 64 and 128, a ragged S, the
model's strided layout; its own launch count must move), the f32 one,
and the two-kernel decode, also replayed as a CUDA graph while ``pos``
changes on the card (the same bits as eager calls).
Imports neither JAX nor the reference, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_attention_card.py

Without a card every test skips."""

import pytest
import torch

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops

#: the reference kernel tests' tolerances (tests/test_kernels.py:43, :77)
TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,t,group,causal", [
    (128, 128, 3, True), (100, 100, 1, True), (64, 150, 3, True), (96, 96, 3, False),
])
def test_flash_kernel_matches_plain_on_card(cuda_device, dt, s, t, group, causal):
    g = torch.Generator(device=cuda_device).manual_seed(s + t + group)
    B, KV, hd = 2, 2, 64
    q = torch.randn(B, s, KV * group, hd, generator=g, device=cuda_device).to(dt)
    k = torch.randn(B, t, KV, hd, generator=g, device=cuda_device).to(dt)
    v = torch.randn(B, t, KV, hd, generator=g, device=cuda_device).to(dt)
    n0 = FA.flash_attention_bhsd.launches
    got = ops.flash_attention(q, k, v, causal)
    assert FA.flash_attention_bhsd.launches == n0 + 1
    torch.testing.assert_close(got, FA.attention_ref(q, k, v, causal),
                               atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("q_dt,kv_dt", [(torch.float32, torch.float32),
                                        (torch.float32, torch.bfloat16),
                                        (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("pos", [0, 255, 256, 299, -1])
def test_decode_kernel_matches_plain_on_card(cuda_device, q_dt, kv_dt, pos):
    g = torch.Generator(device=cuda_device).manual_seed(pos + 2)
    B, S, KV, G, hd = 2, 300, 3, 3, 64
    q = torch.randn(B, 1, KV * G, hd, generator=g, device=cuda_device).to(q_dt)
    k = torch.randn(B, S, KV, hd, generator=g, device=cuda_device).to(kv_dt)
    v = torch.randn(B, S, KV, hd, generator=g, device=cuda_device).to(kv_dt)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda_device)
    n0 = DA.decode_attention_bhd.launches
    got = ops.decode_attention(q, k, v, p)
    assert DA.decode_attention_bhd.launches == n0 + 1
    torch.testing.assert_close(got, DA.attention_ref(q[:, 0], k, v, p).unsqueeze(1),
                               atol=TOL[q_dt], rtol=TOL[q_dt])


@pytest.mark.cuda
@pytest.mark.parametrize("s,t,group,causal,hd,strided", [
    (64, 150, 3, True, 64, False), (150, 64, 3, True, 64, False), (128, 128, 1, True, 64, False),
    (96, 200, 3, False, 64, False), (256, 256, 3, True, 128, False), (100, 100, 3, True, 64, False),
    (200, 200, 3, True, 64, True), (130, 130, 2, True, 40, True),
])
def test_flash_tensor_core_variant_on_card(cuda_device, s, t, group, causal, hd, strided):
    """bf16 operands with 16-byte aligned rows take the tensor-core kernel
    (its count moves with the total); strided: q, k and v are head slices
    of wider tensors, as the model's projections can give them."""
    g = torch.Generator(device=cuda_device).manual_seed(s * t + hd)
    B, KV = 2, 2
    H = KV * group
    dt = torch.bfloat16
    if strided:
        q = torch.randn(B, s, 2 * H, hd, generator=g, device=cuda_device).to(dt)[:, :, H:]
        kv = torch.randn(B, t, 2 * KV, hd, generator=g, device=cuda_device).to(dt)
        k, v = kv[:, :, :KV], kv[:, :, KV:]
    else:
        q = torch.randn(B, s, H, hd, generator=g, device=cuda_device).to(dt)
        k = torch.randn(B, t, KV, hd, generator=g, device=cuda_device).to(dt)
        v = torch.randn(B, t, KV, hd, generator=g, device=cuda_device).to(dt)
    n0, tc0 = FA.flash_attention_bhsd.launches, FA.flash_attention_bhsd.tc_launches
    got = ops.flash_attention(q, k, v, causal)
    assert (FA.flash_attention_bhsd.launches, FA.flash_attention_bhsd.tc_launches) == (n0 + 1, tc0 + 1)
    torch.testing.assert_close(got, FA.attention_ref(q, k, v, causal), atol=TOL[dt], rtol=TOL[dt])


#: a cache of 4 splits (every split's edges) and one of 41 splits, past
#: the combine's 32 splits held one a lane and its batches of 16 splits
#: loaded at once (the edges of the 16th and 32nd splits)
_R = DA.SPLIT_ROWS
SPLIT_CASES = {
    "4_splits": (3 * _R + 17, (-1, 0, _R - 1, _R, 2 * _R - 1, 2 * _R, 3 * _R + 16)),
    "41_splits": (40 * _R + 5, (-1, 16 * _R - 1, 16 * _R, 32 * _R - 1, 32 * _R, 33 * _R + 7,
                                40 * _R + 4)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("q_dt,kv_dt", [(torch.float32, torch.float32),
                                        (torch.float32, torch.bfloat16),
                                        (torch.bfloat16, torch.bfloat16),
                                        (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_decode_split_edges_on_card(cuda_device, q_dt, kv_dt, case):
    """Positions at both sides of split boundaries of the wrapper's split
    size, the first and last row, and pos -1 (every split live, a uniform
    softmax), over an f32 or bf16 cache."""
    S, positions = SPLIT_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(S)
    B, KV, G, hd = 2, 3, 3, 64
    q = torch.randn(B, 1, KV * G, hd, generator=g, device=cuda_device).to(q_dt)
    k = torch.randn(B, S, KV, hd, generator=g, device=cuda_device).to(kv_dt)
    v = torch.randn(B, S, KV, hd, generator=g, device=cuda_device).to(kv_dt)
    for pos in positions:
        p = torch.tensor(pos, dtype=torch.int32, device=cuda_device)
        torch.testing.assert_close(ops.decode_attention(q, k, v, p),
                                   DA.attention_ref(q[:, 0], k, v, p).unsqueeze(1),
                                   atol=TOL[q_dt], rtol=TOL[q_dt])


@pytest.mark.cuda
def test_decode_graph_replay_follows_pos_on_card(cuda_device):
    """One decode attention captured in a CUDA graph, replayed after pos
    is changed on the card: no host sync and no grid size depends on pos,
    so every replay equals an eager call at that pos, bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    B, S, KV, G, hd = 8, 1160, 3, 3, 64
    dt = torch.bfloat16
    q = torch.randn(B, 1, KV * G, hd, generator=g, device=cuda_device).to(dt)
    k = torch.randn(B, S, KV, hd, generator=g, device=cuda_device).to(dt)
    v = torch.randn(B, S, KV, hd, generator=g, device=cuda_device).to(dt)
    p = torch.tensor(0, dtype=torch.int32, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.decode_attention(q, k, v, p)  # builds and loads the kernels outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention(q, k, v, p)
    R = DA.SPLIT_ROWS
    for pos in (0, R - 1, R, 700, 1087, S - 1, -1):
        p.fill_(pos)
        graph.replay()
        eager = ops.decode_attention(q, k, v, p)
        torch.cuda.synchronize()
        assert torch.equal(out, eager), pos
        torch.testing.assert_close(out, DA.attention_ref(q[:, 0], k, v, p).unsqueeze(1),
                                   atol=TOL[dt], rtol=TOL[dt])
