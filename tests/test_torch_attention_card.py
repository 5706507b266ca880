"""On a CUDA card: the port's attention kernels against their plain
versions, at shapes and positions the serving path's check in
``chip_smoke.py`` does not take (S != T, groups 1 and 3, non-causal, the
decode tiles' edges, pos < 0, an f32 query over f32 and bf16 caches).
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
