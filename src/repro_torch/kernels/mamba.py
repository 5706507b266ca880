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
any ``S >= 1`` and ``ds`` 8 or 16 (:data:`D_STATES`): a decode kernel at
``S == 1``, a prefill kernel otherwise.

:func:`selective_scan_ref` is the plain version: the per-token loop of
``_ssm_scan`` in torch ops, whose state update (the rounded product
``dt A``, its exp, the rounded products ``da h`` and ``(dt x) B``, their
rounded sum) the kernels repeat bit for bit; ``y`` sums over ``s`` in
another order there, so the kernels' ``y`` is held to it within a
tolerance.  :func:`selective_scan_kernel_order` computes the kernels'
own ``y`` order in torch ops (bit for bit on the card).  A wrapper given
CPU tensors runs the plain version; given CUDA tensors it launches the
kernel or raises.  ``selective_scan.launches`` counts the kernel's
launches.

**Backward.**  The reference trains through ``jax.grad`` of its
``lax.scan``.  Given an operand that requires a gradient,
:func:`selective_scan` runs inside :class:`SelectiveScan`, an autograd
Function whose forward is the same call (the same launch and bits, or the
plain version on the CPU) and whose backward is
:func:`selective_scan_bwd`: the hand-written CUDA kernel
``csrc/mamba_scan_bwd.cu`` on CUDA tensors, :func:`selective_scan_bwd_ref`
(the reverse recurrence in torch ops) on CPU ones.  With ``Gc`` the
gradient reaching a state from the tokens after it, ``G_t = C_t dy_t +
Gc`` and ``Gc <- exp(dt_t A) G_t``; it gives ``ddt``, ``dx``, ``dA``
(summed over the batch and the sequence), ``dB``, ``dC`` (summed over the
channels) and ``dh0``; the states are recomputed forwards, never
recovered by dividing by ``exp(dt A)``.  The Function saves its inputs
only.  ``selective_scan_bwd.launches`` counts the backward's launches
(one a call, three device kernels).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .flash_attention import _check_device
from .guard import needs_guard
from .sim_step import _aligned16, _raise_on, _stream_ptr

__all__ = ["D_STATES", "selective_scan_ref", "selective_scan_kernel_order", "selective_scan",
           "selective_scan_bwd_ref", "selective_scan_bwd", "SelectiveScan",
           "sample_scan_inputs"]

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


def selective_scan_kernel_order(dt: torch.Tensor, x: torch.Tensor, A: torch.Tensor,
                                Bc: torch.Tensor, Cc: torch.Tensor,
                                h0: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' arithmetic in torch ops, inputs and outputs as
    :func:`selective_scan_ref`: the same state update, and ``y`` in the
    kernels' order (``csrc/mamba_scan.cu``, both kernels): a channel's
    states split into ``L = ds / 4`` lanes of 4, each lane's rounded
    products summed in state order into ``p_q``, then ``(p_0 + p_2) +
    (p_1 + p_3)`` at ds 16 and ``p_0 + p_1`` at ds 8, every product and
    sum rounded alone."""
    B, S, din = x.shape
    ds = A.shape[1]
    if ds not in D_STATES:
        raise ValueError(f"selective_scan_kernel_order: d_state {ds} is not one of {D_STATES}")
    h = (x.new_zeros((B, din, ds)) if h0 is None else h0)
    ys = []
    for t in range(S):
        dti = dt[:, t]
        h = torch.exp(dti[..., None] * A) * h + (dti * x[:, t])[..., None] * Bc[:, t, None, :]
        prod = (h * Cc[:, t, None, :]).view(B, din, ds // 4, 4)
        p = ((prod[..., 0] + prod[..., 1]) + prod[..., 2]) + prod[..., 3]
        ys.append((p[..., 0] + p[..., 2]) + (p[..., 1] + p[..., 3]) if ds == 16
                  else p[..., 0] + p[..., 1])
    return torch.stack(ys, dim=1), h


def selective_scan_bwd_ref(dt: torch.Tensor, x: torch.Tensor, A: torch.Tensor,
                           Bc: torch.Tensor, Cc: torch.Tensor, h0: Optional[torch.Tensor],
                           dy: torch.Tensor, dhT: Optional[torch.Tensor] = None):
    """Plain backward: the inputs of :func:`selective_scan_ref`, ``dy``
    ``(B, S, din)`` and the final state's gradient ``dhT`` (zeros if None)
    -> ``(ddt, dx, dA, dB, dC, dh0)``, f32 (``dh0`` None when ``h0`` is).
    The states are run forwards and kept; the gradient runs backwards,
    each product and sum a torch op of its own, as the kernel rounds
    them."""
    B, S, din = x.shape
    h = x.new_zeros((B, din, A.shape[1])) if h0 is None else h0
    hs = [h]
    for t in range(S):
        dti = dt[:, t]
        h = torch.exp(dti[..., None] * A) * h + (dti * x[:, t])[..., None] * Bc[:, t, None, :]
        hs.append(h)
    Gc = torch.zeros_like(h) if dhT is None else dhT
    ddt, dx = torch.empty_like(x), torch.empty_like(x)
    dB, dC = torch.empty_like(Bc), torch.empty_like(Cc)
    dA = torch.zeros_like(A)
    for t in reversed(range(S)):
        dti, xi, dyi = dt[:, t], x[:, t], dy[:, t]
        G = Cc[:, t, None, :] * dyi[..., None] + Gc
        u = dti * xi
        dC[:, t] = torch.einsum("bd,bds->bs", dyi, hs[t + 1])
        dB[:, t] = torch.einsum("bds,bd->bs", G, u)
        du = (G * Bc[:, t, None, :]).sum(-1)
        da = torch.exp(dti[..., None] * A)
        gz = G * hs[t] * da
        ddt[:, t] = du * xi + (gz * A).sum(-1)
        dx[:, t] = du * dti
        dA = dA + (gz * dti[..., None]).sum(0)
        Gc = da * G
    return ddt, dx, dA, dB, dC, (None if h0 is None else Gc)


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
    ``h0``, ``state_out`` and ``A`` need not be 16-byte aligned on the
    card: the kernels move the state 16 bytes a lane where all three are
    aligned and 4 bytes at a time where one is not, with the same bits.
    Nothing is copied: ``state_out`` is written where it lies, so a view
    into a larger cache is updated in place.

    CUDA tensors launch the kernel; CPU tensors run
    :func:`selective_scan_ref`.  Given an operand that requires a gradient
    the call runs inside :class:`SelectiveScan` (backward:
    :func:`selective_scan_bwd`); the final state then goes to a fresh
    tensor, copied into ``state_out``."""
    dev = _check(dt, x, A, Bc, Cc, h0, state_out)
    if needs_guard(dt, x, A, Bc, Cc, h0):
        y, h = SelectiveScan.apply(dt, x, A, Bc, Cc, h0)
        if state_out is not None:
            with torch.no_grad():
                state_out.copy_(h)
        return y, h
    if dev.type == "cpu":
        y, h = selective_scan_ref(dt, x, A, Bc, Cc, h0)
        return y, (h if state_out is None else state_out.copy_(h))
    return _run(dt, x, A, Bc, Cc, h0, state_out)


selective_scan.launches = 0


class SelectiveScan(torch.autograd.Function):
    """``apply(dt, x, A, Bc, Cc, h0) -> (y, h_final)``: forward
    :func:`selective_scan`'s launch (or plain version) into fresh tensors;
    backward :func:`selective_scan_bwd` on the saved inputs."""

    @staticmethod
    def forward(ctx, dt, x, A, Bc, Cc, h0):
        if x.device.type == "cpu":
            y, h = selective_scan_ref(dt, x, A, Bc, Cc, h0)
        else:
            y, h = _run(dt, x, A, Bc, Cc, h0, None)
        ctx.save_for_backward(dt, x, A, Bc, Cc, h0)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dhT):
        dt, x, A, Bc, Cc, h0 = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dhT = None if dhT is None else dhT.contiguous()  # autograd may hand expanded grads
        return selective_scan_bwd(dt, x, A, Bc, Cc, h0, dy, dhT)


def selective_scan_bwd(dt: torch.Tensor, x: torch.Tensor, A: torch.Tensor, Bc: torch.Tensor,
                       Cc: torch.Tensor, h0: Optional[torch.Tensor], dy: torch.Tensor,
                       dhT: Optional[torch.Tensor] = None):
    """The scan's backward: the forward's inputs, ``dy`` ``(B, S, din)``
    and ``dhT`` (None: zeros), f32 -> ``(ddt, dx, dA, dB, dC, dh0)``
    (``dh0`` None when ``h0`` is).  CUDA tensors launch
    ``csrc/mamba_scan_bwd.cu`` (one call, three device kernels: counted
    once in ``selective_scan_bwd.launches``; ``A``, ``h0`` and ``dhT`` are
    copied first where they are not 16-byte aligned); CPU tensors run
    :func:`selective_scan_bwd_ref`."""
    dev = _check(dt, x, A, Bc, Cc, h0, dhT)
    if tuple(dy.shape) != tuple(x.shape) or dy.dtype != torch.float32:
        raise ValueError(f"selective_scan_bwd: dy must be f32 of x's shape {tuple(x.shape)}")
    _check_device("selective_scan_bwd", (x, dy))
    if dev.type == "cpu":
        return selective_scan_bwd_ref(dt, x, A, Bc, Cc, h0, dy, dhT)
    from . import build

    B, S, din = x.shape
    ds = A.shape[1]
    if ds not in D_STATES:
        raise ValueError(f"selective_scan_bwd: d_state {ds} is not one of {D_STATES}")
    if B > 65535:
        raise ValueError("selective_scan_bwd: batch must be <= 65535")
    lib = build.load("mamba_scan_bwd")
    chunk, parts = lib.selective_scan_bwd_chunk(), lib.selective_scan_bwd_parts(B, din)
    dt, x, Bc, Cc, dy = (t.contiguous() for t in (dt, x, Bc, Cc, dy))
    A = _aligned16(A.contiguous())
    h0, dhT = (None if t is None else _aligned16(t.contiguous()) for t in (h0, dhT))

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    ddt, dx, dA, dB, dC = new(B, S, din), new(B, S, din), new(din, ds), new(B, S, ds), new(B, S, ds)
    dh0 = None if h0 is None else new(B, din, ds)
    states = new(B * ((S + chunk - 1) // chunk) * din * ds)
    bc_part = new(B * parts * S * 2 * ds)
    dA_part = new(B * din * ds)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.selective_scan_bwd(
        *(ptr(t) for t in (dt, x, A, Bc, Cc, h0, dy, dhT, ddt, dx, dA, dB, dC, dh0, states,
                           bc_part, dA_part)), B, S, din, ds, _stream_ptr(dev))
    _raise_on("selective_scan_bwd", rc)
    selective_scan_bwd.launches += 1
    return ddt, dx, dA, dB, dC, dh0


selective_scan_bwd.launches = 0


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
