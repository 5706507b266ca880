"""Mamba's selective scan: the plain PyTorch version and the CUDA kernel
wrapper.

Per (batch, channel d), with the state ``h`` ``(ds,)`` (f32) carried over
the sequence::

    h <- exp(dt_t A[d]) * h + (dt_t x_t) B_t
    y_t = h . C_t

:func:`selective_scan` computes it on ``dt``, ``x`` ``(B, S, din)``, ``A``
``(din, ds)``, ``B_t`` / ``C_t`` rows ``Bc``, ``Cc`` ``(B, S, ds)`` and the
initial state ``h0`` ``(B, din, ds)`` (zeros if None), all f32, and
returns ``y`` ``(B, S, din)`` and the final state, which it writes into
``state_out`` when given (it may be ``h0``: the serving cache, updated in
place).  It is the reference's ``models/ssm._ssm_scan``, a ``lax.scan``
with no Pallas kernel; on the card it runs as the hand-written kernel
``csrc/mamba_scan.cu`` (built by :mod:`.build`), one launch a call, for
any ``S >= 1`` and ``ds`` 8 or 16 (:data:`D_STATES`).

:func:`selective_scan_ref` is the plain version: the per-token loop of
``_ssm_scan`` in torch ops, whose state update (the rounded product
``dt A``, its exp, the rounded products ``da h`` and ``(dt x) B``, their
rounded sum) the kernel repeats bit for bit; ``y`` sums over ``s`` in
another order there, so the kernel's ``y`` is held to it within a
tolerance.  A wrapper given CPU tensors runs the plain version, through
which autograd goes (``loss_fn`` trains a Mamba block on the CPU, as the
reference differentiates its ``lax.scan``); given CUDA tensors it launches
the kernel or raises, and the call has no backward (behind
:class:`.guard.NoBackward`: the kernel has none yet).
``selective_scan.launches`` counts the kernel's launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .flash_attention import _check_device
from .guard import NoBackward, needs_guard
from .sim_step import _raise_on, _stream_ptr

__all__ = ["D_STATES", "selective_scan_ref", "selective_scan", "sample_scan_inputs"]

#: state sizes the kernel is built for (Jamba's 16, ``reduced()``'s 8)
D_STATES = (8, 16)


def selective_scan_ref(dt: torch.Tensor, x: torch.Tensor, A: torch.Tensor,
                       Bc: torch.Tensor, Cc: torch.Tensor,
                       h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``dt``, ``x`` ``(B, S, din)``, ``A`` ``(din, ds)``,
    ``Bc``, ``Cc`` ``(B, S, ds)``, ``h0`` ``(B, din, ds)`` (zeros if None),
    f32 -> ``(y (B, S, din), h_final (B, din, ds))``."""
    B, S, din = x.shape
    h = (x.new_zeros((B, din, A.shape[1])) if h0 is None else h0)
    ys = []
    for t in range(S):
        dti = dt[:, t]
        da = torch.exp(dti[..., None] * A)
        h = da * h + (dti * x[:, t])[..., None] * Bc[:, t, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, Cc[:, t]))
    return torch.stack(ys, dim=1), h


def _check(dt, x, A, Bc, Cc, h0, state_out):
    name = "selective_scan"
    for arg, t, nd in (("dt", dt, 3), ("x", x, 3), ("A", A, 2), ("Bc", Bc, 3), ("Cc", Cc, 3)):
        if not isinstance(t, torch.Tensor) or t.dim() != nd:
            raise TypeError(f"{name}: {arg} must be a {nd}-D tensor")
    B, S, din = x.shape
    ds = A.shape[1]
    if B < 1 or S < 1 or din < 1:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")
    if dt.shape != x.shape or A.shape[0] != din:
        raise ValueError(f"{name}: dt {tuple(dt.shape)} / A {tuple(A.shape)} do not match "
                         f"x {tuple(x.shape)}")
    for arg, t in (("Bc", Bc), ("Cc", Cc)):
        if tuple(t.shape) != (B, S, ds):
            raise ValueError(f"{name}: {arg} must have shape {(B, S, ds)}")
    states = [("h0", h0), ("state_out", state_out)]
    for arg, t in states:
        if t is not None and (not isinstance(t, torch.Tensor)
                              or tuple(t.shape) != (B, din, ds)):
            raise ValueError(f"{name}: {arg} must have shape {(B, din, ds)}")
    given = [t for _, t in states if t is not None]
    for arg, t in [("dt", dt), ("x", x), ("A", A), ("Bc", Bc), ("Cc", Cc)] + states:
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected float32")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {arg}'s last dimension is not contiguous")
    return _check_device(name, (dt, x, A, Bc, Cc, *given))


def _launch(dt, x, A, Bc, Cc, h0, y, hT) -> None:
    from . import build

    B, S, din = x.shape
    ds = A.shape[1]
    if ds not in D_STATES:
        raise ValueError(f"selective_scan: d_state {ds} is not one of {D_STATES}")
    if B > 65535:
        raise ValueError("selective_scan: batch must be <= 65535")
    for arg, t in (("A", A), ("h0", h0), ("state_out", hT)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"selective_scan: {arg} must be contiguous on the card")

    def bs(t):
        return t.stride(0), t.stride(1)

    rc = build.load("mamba_scan").selective_scan_fwd(
        dt.data_ptr(), x.data_ptr(), A.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
        B, S, din, ds, *bs(dt), *bs(x), *bs(Bc), *bs(Cc), *bs(y), _stream_ptr(x.device))
    _raise_on("selective_scan", rc)
    selective_scan.launches += 1


def _run(dt, x, A, Bc, Cc, h0, state_out) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = x.device
    y = torch.empty(x.shape, dtype=torch.float32, device=dev)
    hT = state_out if state_out is not None else torch.empty(
        (x.shape[0], x.shape[2], A.shape[1]), dtype=torch.float32, device=dev)
    _launch(dt, x, A, Bc, Cc, h0, y, hT)
    return y, hT


def selective_scan(dt: torch.Tensor, x: torch.Tensor, A: torch.Tensor, Bc: torch.Tensor,
                   Cc: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
                   state_out: Optional[torch.Tensor] = None):
    """The scan (shapes in the module docstring; any strides with the last
    dimension contiguous, ``A``, ``h0`` and ``state_out`` contiguous on the
    card) -> ``(y, h_final)``: a fresh ``(B, S, din)`` f32 and the final
    state, written into ``state_out`` when given (which may be ``h0``).

    CUDA tensors launch the kernel (given an operand that requires a
    gradient, the call has no backward and the final state goes to a fresh
    tensor, copied into ``state_out``); CPU tensors run
    :func:`selective_scan_ref`, differentiable."""
    dev = _check(dt, x, A, Bc, Cc, h0, state_out)
    if dev.type == "cpu":
        y, h = selective_scan_ref(dt, x, A, Bc, Cc, h0)
        if state_out is None:
            return y, h
        with torch.no_grad():
            state_out.copy_(h)
        return y, (h if h.requires_grad else state_out)
    if not needs_guard(dt, x, A, Bc, Cc, h0):
        return _run(dt, x, A, Bc, Cc, h0, state_out)
    y, h = NoBackward.apply("selective_scan", _run, {}, dt, x, A, Bc, Cc, h0, None)
    return y, (h if state_out is None else state_out.copy_(h))


selective_scan.launches = 0


def sample_scan_inputs(B: int, S: int, din: int, ds: int, seed: int, *, device="cpu",
                       with_h0: bool = True):
    """Inputs of Mamba's laws from ``np.random.default_rng(seed)``: ``dt``
    a softplus of N(-4.6, 1) (the init's bias, a unit spread), ``x`` ~ N(0,
    1), ``A = -exp(log(1..ds))`` per channel times U(0.5, 2), ``Bc``,
    ``Cc`` ~ N(0, 1), ``h0`` ~ 0.1 N(0, 1) (None without ``with_h0``);
    f32 on ``device``: ``(dt, x, A, Bc, Cc, h0)``."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    dt = t(np.logaddexp(rng.standard_normal((B, S, din)) - 4.6, 0.0))
    x = t(rng.standard_normal((B, S, din)))
    A = t(-np.arange(1, ds + 1)[None, :] * rng.uniform(0.5, 2.0, (din, 1)))
    Bc = t(rng.standard_normal((B, S, ds)))
    Cc = t(rng.standard_normal((B, S, ds)))
    h0 = t(rng.standard_normal((B, din, ds)) * 0.1) if with_h0 else None
    return dt, x, A, Bc, Cc, h0
