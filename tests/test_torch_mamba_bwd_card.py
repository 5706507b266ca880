"""On a CUDA card: the backward of Mamba's selective scan
(``csrc/mamba_scan_bwd.cu``, :func:`repro_torch.kernels.mamba.
selective_scan_bwd`) against its plain version
:func:`selective_scan_bwd_ref`, at both built state sizes (8 and 16), one
token, sequences ending on and beside a chunk's edge
(``selective_scan_bwd_chunk()`` tokens), channel counts that are not a
multiple of a block's 128, a batch row whose blocks walk several channel
groups (the last one partial), one batch row, with and without an initial
state and a final state's gradient, Jamba's training shape, and the path
through ``ops.selective_scan`` under autograd.  Imports neither
JAX nor the reference, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mamba_bwd_card.py

Without a card every test skips.

dh0 must equal the plain version's bit for bit (the carried gradient's
elementwise chain, rounded alike, libdevice's ``expf`` as ``torch.exp``);
the reduced gradients (ddt over the state, dB and dC over the channels,
dA over the batch and the sequence) sum in other orders and are held
within ``TOL`` of each gradient's max.  Two calls give the same bits: no
atomics."""

import pytest
import torch

from repro_torch.kernels import mamba as M
from repro_torch.kernels import ops

TOL = 1e-5
NAMES = ("ddt", "dx", "dA", "dB", "dC", "dh0")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _case(B, S, din, ds, seed, dev, with_h0=True, with_dhT=True):
    dt, x, A, Bc, Cc, h0 = M.sample_scan_inputs(B, S, din, ds, seed, device=dev,
                                                with_h0=with_h0)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dy = torch.randn((B, S, din), generator=g, device=dev)
    dhT = torch.randn((B, din, ds), generator=g, device=dev) * 0.1 if with_dhT else None
    return dt, x, A, Bc, Cc, h0, dy, dhT


def _check(got, want):
    torch.cuda.synchronize()
    for name, a, b in zip(NAMES, got, want):
        if b is None:
            assert a is None, name
            continue
        assert a.shape == b.shape and a.dtype == torch.float32, name
        assert bool(torch.isfinite(a).all()), name
        if name == "dh0":
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                f"dh0: {int((a != b).sum())} entries differ"
            continue
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        assert err <= TOL * scale, f"{name}: off by {err} (max {scale})"


def _chunk():
    """Tokens between the states the kernel stores, from the library."""
    from repro_torch.kernels import build

    return build.load("mamba_scan_bwd").selective_scan_bwd_chunk()


#: sequence lengths as functions of the chunk c
_LENGTHS = {"1": lambda c: 1, "c-1": lambda c: c - 1, "c": lambda c: c,
            "c+1": lambda c: c + 1, "4c+5": lambda c: 4 * c + 5, "5c": lambda c: 5 * c,
            "41c+5": lambda c: 41 * c + 5}


@pytest.mark.cuda
@pytest.mark.parametrize("ds", M.D_STATES)
@pytest.mark.parametrize("B,S,din,with_h0,with_dhT", [
    (2, "1", 256, True, True), (2, "c", 128, True, False), (3, "c+1", 200, False, True),
    (1, "41c+5", 64, True, True), (4, "5c", 4096, False, False),
    (2, "c-1", 256, True, True), (4, "4c+5", 5000, True, True), (1, "c+1", 300, True, True)])
def test_bwd_matches_plain_on_card(cuda_device, ds, B, S, din, with_h0, with_dhT):
    S = _LENGTHS[S](_chunk())
    x = _case(B, S, din, ds, seed=ds + S + din, dev=cuda_device, with_h0=with_h0,
              with_dhT=with_dhT)
    n0 = M.selective_scan_bwd.launches
    got = M.selective_scan_bwd(*x)
    assert M.selective_scan_bwd.launches == n0 + 1
    _check(got, M.selective_scan_bwd_ref(*x))


@pytest.mark.cuda
def test_training_shape_and_same_bits(cuda_device):
    """Jamba's training step: 8 x 1024 tokens, 16384 channels, ds 16, no
    initial state; a second call gives the same bits."""
    x = _case(8, 1024, 16384, 16, seed=11, dev=cuda_device, with_h0=False, with_dhT=False)
    got = M.selective_scan_bwd(*x)
    again = M.selective_scan_bwd(*x)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)
    _check(got, M.selective_scan_bwd_ref(*x))


@pytest.mark.cuda
def test_ops_selective_scan_trains_on_card(cuda_device):
    """``ops.selective_scan`` under autograd, B and C sliced from one
    product as in the model: the forward kernel's bits, the backward
    kernel's gradients, one launch of each."""
    dt, x, A, Bc, Cc, h0, dy, _ = _case(2, 30, 512, 16, seed=3, dev=cuda_device,
                                        with_dhT=False)
    dbc = torch.cat([torch.zeros(2, 30, 3, device=cuda_device), Bc, Cc], dim=-1)
    leaves = [t.clone().requires_grad_(True) for t in (dt, x, A, dbc, h0)]
    f0, b0 = M.selective_scan.launches, M.selective_scan_bwd.launches
    y, _ = ops.selective_scan(leaves[0], leaves[1], leaves[2], leaves[3][..., 3:19],
                              leaves[3][..., 19:], leaves[4])
    grads = torch.autograd.grad((y * dy).sum(), leaves)
    assert (M.selective_scan.launches - f0, M.selective_scan_bwd.launches - b0) == (1, 1)
    want = M.selective_scan_bwd_ref(dt, x, A, Bc, Cc, h0, dy)
    _check((grads[0], grads[1], grads[2], grads[3][..., 3:19], grads[3][..., 19:], grads[4]),
           want)
    assert not bool(grads[3][..., :3].any())


@pytest.mark.cuda
def test_card_refuses_what_the_kernel_does_not_take(cuda_device):
    dt, x, A, Bc, Cc, h0, dy, _ = _case(2, 4, 64, 8, seed=3, dev=cuda_device)
    with pytest.raises(ValueError, match="dy"):
        M.selective_scan_bwd(dt, x, A, Bc, Cc, h0, dy[:, :2])
    dt4, x4, A4, B4, C4, h4, dy4, _ = _case(2, 4, 64, 4, seed=3, dev=cuda_device)
    with pytest.raises(ValueError, match="d_state 4"):
        M.selective_scan_bwd(dt4, x4, A4, B4, C4, h4, dy4)
