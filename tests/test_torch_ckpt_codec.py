"""The port's checkpoint codec kernels (plain versions on the CPU) against
the reference: bit for bit against the host codec that owns the file
format (``repro.checkpoint.codec``), and within stated tolerances against
the Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import codec as RC
from repro.kernels import ops as ROPS
from repro.kernels.ckpt_codec import dequantize_blocks as pallas_dequantize
from repro.kernels.ckpt_codec import quantize_blocks as pallas_quantize
from repro_torch.kernels import ckpt_codec as CK
from repro_torch.kernels import ops

BLOCK = 256


def _random_blocks(seed: int, nb: int):
    """Normal blocks at block scales from e^-20 to e^5, and a ``prev`` 1e-3
    (relative) away."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((nb, BLOCK)) * np.exp(rng.uniform(-20, 5, (nb, 1))))
    prev = x * (1.0 - 1e-3 * rng.standard_normal((nb, BLOCK)))
    return x.astype(np.float32).reshape(-1), prev.astype(np.float32).reshape(-1)


def _leaves():
    yield "random", *_random_blocks(0, 64)
    for seed in (1, 2):
        yield f"edge{seed}", *CK.sample_codec_leaf(seed)


def _payload(q: torch.Tensor, s: torch.Tensor) -> np.ndarray:
    return np.concatenate([q.numpy().reshape(-1).view(np.uint8), s.numpy().reshape(-1).view(np.uint8)])


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint32)


# --------------------------------------------------------------------------- #
# Plain versions against the host codec: bit for bit
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("name,x,prev", list(_leaves()), ids=lambda v: v if isinstance(v, str) else "")
def test_plain_codec_matches_host_codec_bits(name, x, prev, delta):
    """Codes and scales (NaN payloads included) equal ``_pack``'s, and the
    decode equals ``decode_array``'s, on random and edge blocks: zeros,
    -0, subnormals, .5 ties, NaN, ±Inf, scales 1e-30..1e30, a padded
    tail."""
    p = prev if delta else None
    with np.errstate(invalid="ignore"):
        hq, hs = RC._pack(x if p is None else x - p)
        pay, meta = RC.encode_array(x, p)
        want = RC.decode_array(pay, meta, p)
    q, s = CK.quantize_ref(torch.from_numpy(x), None if p is None else torch.from_numpy(p))
    np.testing.assert_array_equal(q.numpy(), hq)
    np.testing.assert_array_equal(_bits(s.numpy().reshape(-1)), _bits(hs))
    np.testing.assert_array_equal(_payload(q, s), pay)
    got = CK.dequantize_ref(q, s, None if p is None else torch.from_numpy(p), n=x.size)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    if name.startswith("edge"):
        assert np.isnan(hs).any() and np.isinf(hs).any() and (hs == np.float32(1e-12)).any()


@pytest.mark.parametrize("delta", [False, True])
def test_wrappers_run_plain_versions_on_cpu(delta):
    x, prev = CK.sample_codec_leaf(3)
    xt, pt = torch.from_numpy(x), torch.from_numpy(prev) if delta else None
    before = (CK.quantize_blocks.launches, CK.dequantize_blocks.launches)
    q, s = CK.quantize_blocks(xt, pt)
    qr, sr = CK.quantize_ref(xt, pt)
    assert torch.equal(q, qr) and torch.equal(s.view(torch.int32), sr.view(torch.int32))
    assert q.shape == (68, BLOCK) and s.shape == (68, 1)
    d = CK.dequantize_blocks(q, s, pt, n=x.size)
    assert torch.equal(d.view(torch.int32), CK.dequantize_ref(q, s, pt, n=x.size).view(torch.int32))
    assert (CK.quantize_blocks.launches, CK.dequantize_blocks.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "prev_size", "stride", "n"])
def test_wrappers_reject_bad_inputs(bad):
    x = torch.zeros(1000)
    if bad == "dtype":
        with pytest.raises(TypeError):
            CK.quantize_blocks(x.double())
    elif bad == "prev_size":
        with pytest.raises(ValueError):
            CK.quantize_blocks(x, torch.zeros(999))
    elif bad == "stride":
        with pytest.raises(ValueError):
            CK.quantize_blocks(torch.zeros(2000)[::2])
    else:
        q, s = CK.quantize_blocks(x)
        with pytest.raises(ValueError):
            CK.dequantize_blocks(q, s, n=1025)


# --------------------------------------------------------------------------- #
# Plain versions against the Pallas kernel (interpret mode)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("delta", [False, True])
def test_plain_codec_matches_pallas_kernel(delta):
    """The Pallas kernel is held to tolerances, not bits, for two measured
    causes: XLA rewrites ``absmax / 127.0`` as a multiply by the
    reciprocal, so about 4% of its scales sit 1 ulp off the host codec's
    IEEE division; and its delta dequantize rounds ``q * s + prev`` once
    (an FMA) where the host codec rounds the product and the sum apart.
    Scales within 1 ulp, codes equal wherever the scales are, decoded
    values within 2^-22 (|q s| + |prev|)."""
    nb = 512
    x, prev = _random_blocks(7 + delta, nb)
    p = prev if delta else None
    jp = None if p is None else jnp.asarray(p.reshape(nb, BLOCK))
    pq, ps = pallas_quantize(jnp.asarray(x.reshape(nb, BLOCK)), jp, tile=nb, interpret=True)
    q, s = CK.quantize_ref(torch.from_numpy(x), None if p is None else torch.from_numpy(p))
    ps, pq = np.asarray(ps).reshape(-1), np.asarray(pq)
    sn = s.numpy().reshape(-1)
    ulps = np.abs(_bits(ps).astype(np.int64) - _bits(sn).astype(np.int64))
    assert ulps.max() <= 1
    same = ulps == 0
    np.testing.assert_array_equal(pq[same], q.numpy()[same])
    back = np.asarray(pallas_dequantize(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()), jp,
                                        tile=nb, interpret=True)).reshape(-1)
    got = CK.dequantize_ref(q, s, None if p is None else torch.from_numpy(p)).numpy()
    qs = np.abs(q.numpy().astype(np.float32) * s.numpy()).reshape(-1)
    tol = 2.0**-22 * (qs + (0.0 if p is None else np.abs(p)))
    assert np.all(np.abs(back - got) <= tol)


# --------------------------------------------------------------------------- #
# ops entry points
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [1000, 17_280, 2**16 + 3])
@pytest.mark.parametrize("delta", [False, True])
def test_ops_checkpoint_payload_matches_encode_array(n, delta):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    prev = (x * (1 - 1e-3 * rng.standard_normal(n))).astype(np.float32) if delta else None
    pt = None if prev is None else torch.from_numpy(prev)
    q, s, m = ops.quantize_checkpoint(torch.from_numpy(x), pt)
    pay, meta = RC.encode_array(x, prev)
    assert m == n == meta["n"] and s.shape[0] == meta["nblocks"]
    np.testing.assert_array_equal(_payload(q, s), pay)
    back = ops.dequantize_checkpoint(q, s, m, (n,), pt)
    np.testing.assert_array_equal(_bits(back.numpy()), _bits(RC.decode_array(pay, meta, prev)))
    # the reference's entry point (the Pallas kernel) lays out the same
    # blocks: scales within 1 ulp, codes equal where the scales are
    rq, rs, rn = ROPS.quantize_checkpoint(jnp.asarray(x), None if prev is None else jnp.asarray(prev))
    ulps = np.abs(_bits(np.asarray(rs).reshape(-1)).astype(np.int64)
                  - _bits(s.numpy().reshape(-1)).astype(np.int64))
    assert rn == n and np.asarray(rq).shape == tuple(q.shape) and ulps.max() <= 1
    np.testing.assert_array_equal(np.asarray(rq)[ulps == 0], q.numpy()[ulps == 0])


def test_ops_checkpoint_takes_f16_and_shapes():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((30, 576)).astype(np.float16)
    q, s, n = ops.quantize_checkpoint(torch.from_numpy(x))
    pay, meta = RC.encode_array(x)
    np.testing.assert_array_equal(_payload(q, s), pay)
    back = ops.dequantize_checkpoint(q, s, n, x.shape)
    assert back.shape == x.shape and back.dtype == torch.float32
    # decode_array casts back to the leaf's dtype; the store does that after ops
    np.testing.assert_array_equal(back.numpy().astype(np.float16), RC.decode_array(pay, meta))


# --------------------------------------------------------------------------- #
# On the card: each kernel against its plain version
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("delta", [False, True])
def test_kernels_match_plain_versions_on_card(cuda_device, delta):
    for x_np, p_np in (CK.sample_codec_leaf(4), _random_blocks(5, 4096)):
        x = torch.from_numpy(x_np).to(cuda_device)
        p = torch.from_numpy(p_np).to(cuda_device) if delta else None
        q, s = CK.quantize_blocks(x, p)
        qr, sr = CK.quantize_ref(x, p)
        assert torch.equal(q, qr) and torch.equal(s.view(torch.int32), sr.view(torch.int32))
        d = CK.dequantize_blocks(q, s, p, n=x.numel())
        dr = CK.dequantize_ref(q, s, p, n=x.numel())
        assert torch.equal(d.view(torch.int32), dr.view(torch.int32))
