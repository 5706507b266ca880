"""The RWKV-6 WKV recurrence: the plain PyTorch version and the CUDA
kernel wrapper.

Per (batch, head), with the state ``S`` (``hd x hd``, f32) carried over
the sequence::

    y_t = r_t . (S + diag(u) k_tᵀ v_t)
    S  <- diag(w_t) S + k_tᵀ v_t

:func:`wkv6_bhsd` computes it in the reference's kernel layout: ``r``,
``k``, ``v``, ``w`` ``(BH, S, hd)``, ``u`` ``(BH, hd)``, ``s0`` ``(BH,
hd, hd)`` -> ``y`` ``(BH, S, hd)`` and the final state ``(BH, hd, hd)``.
:func:`wkv` is the same function in the model layout: ``(B, S, H, hd)``
inputs, ``u`` ``(H, hd)``, ``s0`` ``(B, H, hd, hd)``.  Both wrap the
hand-written CUDA kernel ``csrc/rwkv6.cu`` (built by :mod:`.build`), which
replaces the reference's Pallas kernel ``wkv6_bhsd``; the kernel takes
strided operands and reads ``u`` per head, so neither layout is copied and
``u`` is never broadcast.  :func:`wkv` takes ``state_out``, a tensor
the final state is written into, which may be ``s0`` itself (the serving
cache, updated in place).

The kernel keeps each (batch, head)'s state in registers, a tile of
``TR x 4`` entries a thread (``TILE_ROWS``), and runs a one-token variant
for ``S == 1`` (a decode step); ``wkv(..., tile_rows=)`` picks another
built tile, for timing.

Everything is f32, as on the reference's path (the model casts r, k, v to
f32 and computes w in f32); hd is 16, 32, 64 or 128.  :func:`wkv_ref` /
:func:`wkv6_ref` are the plain versions: the exact per-token recurrence
of the reference's ``kernels/ref.wkv6_ref`` and ``models/ssm._wkv_scan``,
whose state update (one rounded product ``k_i v_j``, one rounded product
``w_i S_ij``, one rounded sum) the kernel repeats bit for bit.  A wrapper
given CPU tensors runs the plain version; given CUDA tensors it launches
the kernel or raises.  ``wkv6_bhsd.launches`` counts the kernel's launches
from either entry.

**Backward.**  The reference's kernel has no VJP; the reference trains
RWKV6 through ``jax.grad`` of its ``lax.scan``.  Given an operand that
requires a gradient, :func:`wkv` runs inside :class:`WKV`, an autograd
Function whose forward is the same call (the same launch and bits) and
whose backward is :func:`wkv6_bwd`: the hand-written CUDA kernel
``csrc/rwkv6_bwd.cu`` on CUDA tensors, :func:`wkv_bwd_ref` (the reverse
recurrence in torch ops) on CPU ones.  With ``G = dL/dS`` carried
backwards, ``G <- diag(w_t) G + r_t dy_tᵀ``, it gives dr, dk, dv, dw, du
(summed over the batch and the sequence) and ds0; the states are
recomputed forwards, never recovered by dividing by ``w``.  The Function
saves its inputs only (``s0`` may be the serving cache: a caller that
also writes the final state into it in place gets autograd's error, not a
wrong gradient).  ``wkv6_bwd.launches`` counts the backward's launches
(one a call, three device kernels).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .flash_attention import _check_device
from .guard import needs_guard
from .sim_step import _aligned16, _raise_on, _stream_ptr

__all__ = ["HEAD_DIMS", "TILE_ROWS", "wkv_ref", "wkv6_ref", "wkv", "wkv6_bhsd",
           "wkv_bwd_ref", "wkv6_bwd", "WKV", "sample_wkv_inputs"]

#: head dims the kernel is built for
HEAD_DIMS = (16, 32, 64, 128)
#: rows of the state tile a thread owns (4 columns) the kernel is built
#: for, by head dim; the default is the only one, except at hd 64: 8 rows
#: for a prefill, 4 for a decode step (S == 1)
TILE_ROWS = {16: (2,), 32: (4,), 64: (4, 8), 128: (8,)}


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
            u: torch.Tensor, s0: Optional[torch.Tensor] = None):
    """Plain version in the model layout: ``r``, ``k``, ``v``, ``w`` ``(B,
    S, H, hd)``, ``u`` ``(H, hd)`` (or any shape that broadcasts to ``(B,
    H, hd)``), ``s0`` ``(B, H, hd, hd)`` (zeros if None) -> ``(y (B, S, H,
    hd), sT (B, H, hd, hd))``, f32."""
    B, S, H, hd = r.shape
    f32 = torch.float32
    r, k, v, w, u = (x.to(f32) for x in (r, k, v, w, u))
    s = (torch.zeros((B, H, hd, hd), dtype=f32, device=r.device) if s0 is None
         else s0.to(f32))
    y = torch.empty((B, S, H, hd), dtype=f32, device=r.device)
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (B, H, hd_k, hd_v)
        y[:, t] = torch.einsum("bhi,bhij->bhj", r[:, t], s + u[..., None] * kv)
        s = w[:, t, :, :, None] * s + kv
    return y, s


def wkv_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                u: torch.Tensor, s0: Optional[torch.Tensor], dy: torch.Tensor,
                dsT: Optional[torch.Tensor] = None):
    """Plain backward in the model layout: the inputs of :func:`wkv_ref`
    (``u`` ``(Bu, H, hd)``, Bu 1 or B), ``dy`` ``(B, S, H, hd)`` and the
    final state's gradient ``dsT`` (zeros if None) -> ``(dr, dk, dv, dw,
    du, ds0)``, f32; ``du`` has ``u``'s shape (summed over the batch when
    ``u`` is shared), ``ds0`` is None when ``s0`` is.  The states are run
    forwards and kept; ``G = dL/dS`` runs backwards, each product and sum
    a torch op of its own, as the kernel rounds it."""
    B, S, H, hd = r.shape
    f32 = torch.float32
    s = (torch.zeros((B, H, hd, hd), dtype=f32, device=r.device) if s0 is None
         else s0.to(f32))
    states = [s]
    for t in range(S - 1):
        s = w[:, t, :, :, None] * s + k[:, t, :, :, None] * v[:, t, :, None, :]
        states.append(s)
    G = torch.zeros_like(s) if dsT is None else dsT.to(f32)
    dr, dk, dv, dw = (torch.empty((B, S, H, hd), dtype=f32, device=r.device) for _ in range(4))
    du = torch.zeros((B, H, hd), dtype=f32, device=r.device)
    ub = u.expand(B, H, hd)
    for t in reversed(range(S)):
        rt, kt, vt, wt, dyt = r[:, t], k[:, t], v[:, t], w[:, t], dy[:, t]
        sp = states[t]
        kv = kt[..., :, None] * vt[..., None, :]
        dr[:, t] = torch.einsum("bhj,bhij->bhi", dyt, sp + ub[..., None] * kv)
        dkv = G + (rt * ub)[..., None] * dyt[..., None, :]
        dk[:, t] = torch.einsum("bhij,bhj->bhi", dkv, vt)
        dv[:, t] = torch.einsum("bhij,bhi->bhj", dkv, kt)
        dw[:, t] = (G * sp).sum(-1)
        du = du + rt * kt * (vt * dyt).sum(-1, keepdim=True)
        G = wt[..., None] * G + rt[..., None] * dyt[..., None, :]
    du = du.sum(0, keepdim=True) if u.shape[0] == 1 else du
    return dr, dk, dv, dw, du, (None if s0 is None else G)


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, s0: torch.Tensor):
    """Plain version in the kernel layout: ``(BH, S, hd)`` inputs, ``u``
    ``(BH, hd)``, ``s0`` ``(BH, hd, hd)`` -> ``(y (BH, S, hd), sT (BH, hd,
    hd))``."""
    y, s = wkv_ref(*(x.unsqueeze(2) for x in (r, k, v, w)), u.unsqueeze(1),
                   s0.unsqueeze(1))
    return y.squeeze(2), s.squeeze(1)


def _check(name, r, k, v, w, u, s0, state_out):
    for arg, x in (("r", r), ("k", k), ("v", v), ("w", w)):
        if not isinstance(x, torch.Tensor) or x.dim() != 4:
            raise TypeError(f"{name}: {arg} must be a 4-D tensor")
        if x.shape != r.shape:
            raise ValueError(f"{name}: {arg} {tuple(x.shape)} does not match r {tuple(r.shape)}")
    B, S, H, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} is not one of {HEAD_DIMS}")
    if S < 1 or B < 1 or H < 1:
        raise ValueError(f"{name}: empty input {tuple(r.shape)}")
    if (not isinstance(u, torch.Tensor) or u.dim() != 3 or u.shape[0] not in (1, B)
            or u.shape[1] not in (1, H) or u.shape[2] != hd):
        raise ValueError(f"{name}: u must broadcast to (B, H, {hd})")
    states = [("s0", s0), ("state_out", state_out)]
    for arg, x in states:
        if x is not None and (not isinstance(x, torch.Tensor)
                              or tuple(x.shape) != (B, H, hd, hd)):
            raise ValueError(f"{name}: {arg} must have shape {(B, H, hd, hd)}")
    given = [x for _, x in states if x is not None]
    for arg, x in [("r", r), ("k", k), ("v", v), ("w", w), ("u", u)] + states:
        if x is None:
            continue
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} has dtype {x.dtype}, expected float32")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: {arg}'s last dimension is not contiguous")
    return _check_device(name, (r, k, v, w, u, *given))


def _launch(r, k, v, w, u3, s0, y, sT, tile_rows=None) -> None:
    """Launch the kernel on (batch, seq, head, hd) views; ``u3`` is a
    ``(B, H, hd)`` view (strides 0 where broadcast); ``tile_rows`` None
    for the head dim's default tile (the C entry's 0)."""
    from . import build

    B, S, H, hd = r.shape
    if B * H >= 2 ** 31:
        raise ValueError("wkv6_bhsd: batch x heads must be < 2**31")

    def bsh(x):
        s = x.stride()
        return s[0], s[1], s[2]

    rc = build.load("rwkv6").wkv6_fwd_rows(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u3.data_ptr(),
        None if s0 is None else s0.data_ptr(), y.data_ptr(), sT.data_ptr(),
        B, S, H, hd, *bsh(r), *bsh(k), *bsh(v), *bsh(w), u3.stride(0), u3.stride(1),
        *((0, 0, 0) if s0 is None else bsh(s0)), *bsh(y), *bsh(sT), tile_rows or 0,
        _stream_ptr(r.device),
    )
    _raise_on("wkv6_bhsd", rc)
    wkv6_bhsd.launches += 1


def _run(name, r, k, v, w, u3, s0, state_out,
         tile_rows=None) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = _check(name, r, k, v, w, u3, s0, state_out)
    B, S, H, hd = r.shape
    if tile_rows is not None and tile_rows not in TILE_ROWS[hd]:
        raise ValueError(f"{name}: tile_rows {tile_rows} is not one of {TILE_ROWS[hd]} "
                         f"(head dim {hd})")
    if dev.type == "cpu":
        y, s = wkv_ref(r, k, v, w, u3, s0)
        if state_out is None:
            return y, s
        return y, state_out.copy_(s)
    y = torch.empty(r.shape, dtype=torch.float32, device=dev)
    sT = state_out if state_out is not None else torch.empty(
        (B, H, hd, hd), dtype=torch.float32, device=dev)
    _launch(r, k, v, w, u3.expand(B, H, hd), s0, y, sT, tile_rows)
    return y, sT


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, s0: Optional[torch.Tensor] = None, *,
        state_out: Optional[torch.Tensor] = None, tile_rows: Optional[int] = None):
    """The recurrence in the model layout: ``r``, ``k``, ``v``, ``w`` ``(B,
    S, H, hd)`` (any strides with hd contiguous), ``u`` ``(H, hd)``, ``s0``
    ``(B, H, hd, hd)`` or None (zeros), all f32 -> ``(y, sT)``: a fresh
    ``(B, S, H, hd)`` and the final state, written into ``state_out`` when
    given (which may be ``s0``).  ``tile_rows`` (one of ``TILE_ROWS[hd]``)
    runs another built tile than the default; the results are the same.

    CUDA tensors launch the kernel; CPU tensors run :func:`wkv_ref`.  With
    an operand that requires a gradient the call runs inside :class:`WKV`
    (backward: :func:`wkv6_bwd`); the final state then goes to a fresh
    tensor, copied into ``state_out``."""
    if not isinstance(u, torch.Tensor) or u.dim() != 2:
        raise TypeError("wkv: u must be a 2-D (H, hd) tensor")
    u3 = u.unsqueeze(0)
    if not needs_guard(r, k, v, w, u, s0):
        return _run("wkv", r, k, v, w, u3, s0, state_out, tile_rows)
    y, s = WKV.apply(r, k, v, w, u3, s0, tile_rows)
    if state_out is None:
        return y, s
    with torch.no_grad():
        state_out.copy_(s)
    return y, s


class WKV(torch.autograd.Function):
    """``apply(r, k, v, w, u3, s0, tile_rows) -> (y, sT)``: forward
    :func:`wkv`'s launch (or plain version) into fresh tensors; backward
    :func:`wkv6_bwd` on the saved inputs."""

    @staticmethod
    def forward(ctx, r, k, v, w, u3, s0, tile_rows):
        y, sT = _run("wkv", r, k, v, w, u3, s0, None, tile_rows)
        ctx.save_for_backward(r, k, v, w, u3, s0)
        ctx.set_materialize_grads(False)
        return y, sT

    @staticmethod
    def backward(ctx, dy, dsT):
        r, k, v, w, u3, s0 = ctx.saved_tensors
        dy = torch.zeros_like(r) if dy is None else dy.contiguous()
        dsT = None if dsT is None else dsT.contiguous()  # autograd may hand expanded grads
        dr, dk, dv, dw, du, ds0 = wkv6_bwd(r, k, v, w, u3, s0, dy, dsT)
        return dr, dk, dv, dw, du, ds0, None


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u3: torch.Tensor, s0: Optional[torch.Tensor], dy: torch.Tensor,
             dsT: Optional[torch.Tensor] = None):
    """The recurrence's backward in the model layout: the forward's inputs
    (``u3`` ``(1, H, hd)`` or ``(B, H, hd)``), ``dy`` ``(B, S, H, hd)`` and
    ``dsT`` (None: zeros), f32 -> ``(dr, dk, dv, dw, du3, ds0)`` (``ds0``
    None when ``s0`` is).  CUDA tensors launch ``csrc/rwkv6_bwd.cu`` (one
    call, three device kernels: counted once in ``wkv6_bwd.launches``;
    operands not 16-byte aligned are copied first); CPU tensors run
    :func:`wkv_bwd_ref`."""
    dev = _check("wkv6_bwd", r, k, v, w, u3, s0, dsT)
    for arg, x in (("dy", dy),):
        if tuple(x.shape) != tuple(r.shape) or x.dtype != torch.float32:
            raise ValueError(f"wkv6_bwd: {arg} must be f32 of r's shape {tuple(r.shape)}")
    _check_device("wkv6_bwd", (r, dy))
    if dev.type == "cpu":
        return wkv_bwd_ref(r, k, v, w, u3, s0, dy, dsT)
    from . import build

    B, S, H, hd = r.shape
    lib = build.load("rwkv6_bwd")
    chunk, groups = lib.wkv6_bwd_chunk(hd), lib.wkv6_bwd_groups(hd)
    if chunk <= 0:
        raise ValueError(f"wkv6_bwd: head dim {hd} is not built")
    r, k, v, w, dy = (_aligned16(x.contiguous()) for x in (r, k, v, w, dy))
    u3 = u3.contiguous()
    s0, dsT = (None if x is None else _aligned16(x.contiguous()) for x in (s0, dsT))

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dr, dk, dv, dw = (new(B, S, H, hd) for _ in range(4))
    du, ds0 = new(*u3.shape), (None if s0 is None else new(B, H, hd, hd))
    states = new(B * H * ((S + chunk - 1) // chunk) * hd * hd)
    dv_part = new(groups * B * S * H * hd) if groups > 1 else None
    du_part = new(B * H * hd)

    def ptr(x):
        return None if x is None else x.data_ptr()

    rc = lib.wkv6_bwd(*(ptr(x) for x in (r, k, v, w, u3, s0, dy, dsT, dr, dk, dv, dw, du,
                                          ds0, states, dv_part, du_part)),
                      B, S, H, hd, int(u3.shape[0] != 1), _stream_ptr(dev))
    _raise_on("wkv6_bwd", rc)
    wkv6_bwd.launches += 1
    return dr, dk, dv, dw, du, ds0


wkv6_bwd.launches = 0


def wkv6_bhsd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor, s0: torch.Tensor):
    """The recurrence in the kernel layout: ``r``, ``k``, ``v``, ``w``
    ``(BH, S, hd)``, ``u`` ``(BH, hd)``, ``s0`` ``(BH, hd, hd)``, all f32
    -> ``(y (BH, S, hd), sT (BH, hd, hd))``; viewed as batch ``BH`` of one
    head.

    CUDA tensors launch the kernel; CPU tensors run :func:`wkv6_ref`."""
    for arg, x, nd in (("r", r, 3), ("k", k, 3), ("v", v, 3), ("w", w, 3), ("u", u, 2),
                       ("s0", s0, 3)):
        if not isinstance(x, torch.Tensor) or x.dim() != nd:
            raise TypeError(f"wkv6_bhsd: {arg} must be a {nd}-D tensor")
    y, sT = _run("wkv6_bhsd", *(x.unsqueeze(2) for x in (r, k, v, w)), u.unsqueeze(1),
                 s0.unsqueeze(1), None)
    return y.squeeze(2), sT.squeeze(1)


wkv6_bhsd.launches = 0


def sample_wkv_inputs(B: int, S: int, H: int, hd: int, seed: int, *, device="cpu",
                      w_range=(0.001, 0.9999)):
    """Inputs of the reference kernel test's laws (``tests/test_kernels.py``:
    r, k, v ~ 0.3 N(0, 1), w ~ U(w_range), u ~ 0.1 N(0, 1), s0 ~ 0.05
    N(0, 1)) in the model layout, from ``np.random.default_rng(seed)``:
    ``(r, k, v, w, u (H, hd), s0 (B, H, hd, hd))`` f32 on ``device``."""
    rng = np.random.default_rng(seed)
    shape = (B, S, H, hd)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    r, k, v = (t(rng.standard_normal(shape) * 0.3) for _ in range(3))
    w = t(rng.uniform(*w_range, shape))
    u = t(rng.standard_normal((H, hd)) * 0.1)
    s0 = t(rng.standard_normal((B, H, hd, hd)) * 0.05)
    return r, k, v, w, u, s0
