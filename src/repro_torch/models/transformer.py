"""Language model for every family of the reference's configs (dense,
MoE, RWKV6, the Mamba hybrid and the modality-frontend families): the port
of the reference's ``models/transformer.py`` entry points, ``loss_fn``
(training), ``prefill`` and ``decode_step`` (serving).

* Parameters are a plain tree with the reference's layout and key paths:
  ``embed``, ``final_norm`` (and ``lm_head`` when untied) and
  ``blocks/<pattern position>/...``, each block leaf stacked over the
  repeats (``blocks/0/mixer/wq`` is ``(L, D, H, hd)``), so the checkpoint
  store saves them under the reference's keys.  The layer loop is a
  Python ``for`` over the stacked slices.
* Weights are cast to the compute dtype by :meth:`LanguageModel.cast_params`
  except the ``_KEEP_F32`` leaves, as the reference's ``_cast_tree`` does;
  the serving entry points cast what they are given, which costs nothing
  for a tree already cast, so a server casts once when it builds the
  model (:mod:`..launch.serve`) where the reference casts on every call.
  The numbers are the same.  :meth:`LanguageModel.loss_fn` casts each
  layer's slice inside the autograd graph instead, as the reference's
  ``_run_stack`` does, so the gradients reach the f32 masters.
* The serving cache is the reference's: ``pos`` (0-d int32) and per
  pattern position, for an ``attn`` block ``k`` / ``v`` of shape ``(L, B,
  max_seq, KV, hd)`` in bf16; for an ``rwkv`` block the WKV ``state``
  ``(L, B, H, hd, hd)`` in f32 and the previous token's time-mix and
  channel-mix inputs ``last`` / ``cm_last`` ``(L, B, D)`` in bf16; for a
  ``mamba`` block the conv window ``conv`` ``(L, B, d_conv - 1, d_inner)``
  in bf16 and the SSM state ``ssm`` ``(L, B, d_inner, d_state)`` in f32.
  :meth:`LanguageModel.decode_step` updates it **in place** (the new K/V
  rows, the states and last tokens, ``pos``), where the reference returns
  a new tree; a caller that keeps an old state must clone it.
* Modality frontends (musicgen's ``audio_frames``, llava-next's
  ``vision_patches``) are the reference's stubs: the caller passes
  precomputed ``frontend`` embeddings ``(B, prefix, D)``, concatenated
  before the token embeddings in the compute dtype; ``pos`` and the RoPE
  positions count them, and ``loss_fn`` scores the token positions only.

Five block kinds are built (``BLOCKS``): an ``attn`` or ``mamba`` mixer with
a ``dense`` or ``moe`` MLP (:mod:`.moe`; its load-balance loss is summed
over the layers into ``loss_fn``'s ``aux``), and the ``rwkv`` mixer with
the ``rwkv_cm`` channel mix.  That covers every config of the reference.

Remat (``RuntimeFlags.remat_policy``, training only), where the reference
wraps its layer body in ``jax.checkpoint``: ``"full"`` runs each layer's
block under ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``
(its activations recomputed in the backward); ``"dots"`` saves the outputs
of the matrix products without a batch dimension (``aten.mm`` /
``aten.addmm``, the counterpart of ``dots_with_no_batch_dims_saveable``)
and recomputes the rest, ``aten.bmm`` included, through
``create_selective_checkpoint_contexts``.  The block is chosen outside the
checkpointed function (:func:`_train_block` branches on nothing), and the
recomputation repeats the forward's operations, so the loss and the
gradients are those of ``"none"`` bit for bit.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..configs.base import ArchConfig, LayerSpec
from ..core.torch_sim import resolve_device
from . import moe, ssm
from .layers import (
    MLP_SPECS,
    RuntimeFlags,
    attention,
    attention_decode,
    attention_specs,
    cross_entropy_loss,
    init_attention,
    init_mlp,
    rms_norm,
    rope_table,
    swiglu_mlp,
)

__all__ = ["LanguageModel"]

#: parameters kept in float32 inside the compute graph (the reference's
#: set: norm scales, SSM decay / state params, router logits); everything
#: else is cast to the compute dtype
_KEEP_F32 = {
    "mixer_norm",
    "mlp_norm",
    "router",
    "A_log",
    "D_skip",
    "dt_b",
    "w0",
    "u",
    "ln",
    "mu",
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: weight of the (MoE) auxiliary loss in ``loss_fn``, the reference's
_AUX_LOSS_WEIGHT = 0.01
CACHE_DTYPE = torch.bfloat16
#: the block kinds the port builds (those of the reference's configs)
BLOCKS = (LayerSpec("attn", "dense"), LayerSpec("attn", "moe"), LayerSpec("mamba", "dense"),
          LayerSpec("mamba", "moe"), LayerSpec("rwkv", "rwkv_cm"))


def _cast_tree(d: dict, dtype: torch.dtype) -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out[k] = _cast_tree(v, dtype)
        elif k in _KEEP_F32 or not v.is_floating_point():
            out[k] = v
        else:
            out[k] = v.to(dtype)
    return out


def _layer(tree: dict, r: int) -> dict:
    """Layer ``r``'s slice of a stacked block tree (views)."""
    return {k: _layer(v, r) if isinstance(v, dict) else v[r] for k, v in tree.items()}


# --------------------------------------------------------------------------- #
# Blocks: one composition, each part chosen by the block's kind
# --------------------------------------------------------------------------- #
def _block(mixer, mlp, eps, bp, x):
    """One block -> (``x``, its auxiliary loss or ``None``): the residual
    stream plus the mixer over its rms norm, then plus the MLP over its
    own.  ``mixer`` maps ``(p, h)`` to ``y``, ``mlp`` to ``(y, aux)``; the
    serving ones read and write the layer's cache."""
    x = x + mixer(bp["mixer"], rms_norm(x, bp["mixer_norm"], eps))
    y2, aux = mlp(bp["mlp"], rms_norm(x, bp["mlp_norm"], eps))
    return x + y2, aux


def _attn_mixer(p, h, cfg, flags, sin, cos):
    return attention(p, h, cfg, sin, cos, flags, train=True)[0]


def _mamba_mixer(p, h, cfg, flags, sin, cos):
    return ssm.mamba_apply(p, h, cfg)[0]


def _rwkv_mixer(p, h, cfg, flags, sin, cos):
    return ssm.rwkv_apply(p, h)[0]


def _dense_mlp(p, h, cfg, flags):
    return swiglu_mlp(p, h), None


def _moe_mlp(p, h, cfg, flags, rules=None):
    return moe.moe_apply(p, h, cfg, flags.moe_capacity_factor, rules)


def _rwkv_cm_mlp(p, h, cfg, flags):
    return ssm.rwkv_channel_mix(p, h)[0], None


_MIXERS = {"attn": _attn_mixer, "mamba": _mamba_mixer, "rwkv": _rwkv_mixer}
_MLPS = {"dense": _dense_mlp, "moe": _moe_mlp, "rwkv_cm": _rwkv_cm_mlp}


def _train_block(mixer, mlp, cfg, flags, bp, x, sin, cos):
    """One block in training (no cache): the layer's slice cast to the
    compute dtype inside the graph, then :func:`_block` with the mixer and
    the MLP chosen by the caller."""
    return _block(lambda p, h: mixer(p, h, cfg, flags, sin, cos),
                  lambda p, h: mlp(p, h, cfg, flags), cfg.norm_eps,
                  _cast_tree(bp, flags.compute_dtype), x)


#: the products ``"dots"`` keeps: no batch dimension, as
#: ``dots_with_no_batch_dims_saveable`` (``x @ W`` over a ``(B, S, D)`` x
#: folds into ``aten.mm``; an ``aten.bmm`` is recomputed)
_SAVED_UNDER_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_UNDER_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


#: ``checkpoint`` keywords of each remat policy (``"none"`` calls the block)
_REMAT = {
    "full": {},
    "dots": {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                             _dots_policy)},
}
REMAT_POLICIES = ("none",) + tuple(_REMAT)


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the meta device: shapes and dtypes,
    no storage (:meth:`LanguageModel.abstract_params`)."""

    @property
    def device(self):
        return torch.device("meta")


class LanguageModel(nn.Module):
    """The LM of every family of the reference's configs.  Parameters and
    caches are plain trees passed to the entry points, as in the
    reference.

    ``rules`` (:class:`..parallel.sharding.ShardingRules` bound to a mesh
    over a process group; :func:`..launch.steps.build_model` makes them)
    turns on the distributed layer: the entry points then take this
    rank's blocks of the parameters and this data rank's slice of the
    batch, and the MoE blocks run expert-parallel over the model axis with
    their load-balance loss taken over every data rank's tokens
    (:func:`.moe.moe_apply`).  Every other layer is rank-local."""

    def __init__(self, cfg: ArchConfig, flags: Optional[RuntimeFlags] = None, rules=None):
        super().__init__()
        for spec in cfg.pattern:
            if spec not in BLOCKS:
                raise NotImplementedError(
                    f"{cfg.name}: {spec} blocks are in no config of the reference and are "
                    f"not built; the port builds {[(b.mixer, b.mlp) for b in BLOCKS]}")
        self.cfg = cfg
        self.flags = flags if flags is not None else RuntimeFlags()
        if self.flags.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {self.flags.remat_policy!r} is not one of "
                             f"{REMAT_POLICIES}")
        self.param_dtype = _DTYPES[cfg.param_dtype]
        self.rules = rules

    def _mlp(self, kind: str):
        """The MLP function of a block kind, bound to the model's rules."""
        if kind == "moe":
            return functools.partial(_moe_mlp, rules=self.rules)
        return _MLPS[kind]

    # ------------------------------------------------------------------ #
    # Parameters
    # ------------------------------------------------------------------ #
    def init(self, generator: torch.Generator) -> dict:
        """Random parameters on the generator's device, the reference's
        initialisation laws (different numbers: torch's generator is not
        JAX's)."""
        cfg, dt = self.cfg, self.param_dtype
        dev = generator.device
        D, R = cfg.d_model, cfg.n_repeats
        params = {
            "embed": (torch.randn((cfg.vocab_size, D), generator=generator, device=dev)
                      * 0.02).to(dt),
            "final_norm": torch.ones(D, device=dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = (torch.randn((D, cfg.vocab_size), generator=generator,
                                             device=dev) / math.sqrt(D)).to(dt)
        blocks = []
        for spec in cfg.pattern:
            if spec.mixer == "attn":
                mixer = init_attention(generator, cfg, dt, lead=(R,))
            elif spec.mixer == "mamba":
                mixer = ssm.init_mamba(generator, cfg, dt, lead=(R,))
            else:
                mixer = ssm.init_rwkv(generator, cfg, dt, lead=(R,))
            if spec.mlp == "moe":
                mlp = moe.init_moe(generator, cfg, dt, lead=(R,))
            elif spec.mlp == "dense":
                mlp = init_mlp(generator, D, cfg.d_ff, dt, lead=(R,))
            else:
                mlp = ssm.init_rwkv_channel_mix(generator, cfg, dt, lead=(R,))
            blocks.append({
                "mixer": mixer,
                "mixer_norm": torch.ones((R, D), device=dev),
                "mlp": mlp,
                "mlp_norm": torch.ones((R, D), device=dev),
            })
        params["blocks"] = tuple(blocks)
        return params

    def abstract_params(self) -> dict:
        """The parameter tree of :meth:`init` as meta tensors: shapes and
        dtypes, no allocation."""
        return self.init(_MetaGenerator())

    def _block_specs(self, spec: LayerSpec) -> dict:
        cfg = self.cfg
        out: dict = {"mixer_norm": ("d_model",)}
        if spec.mixer == "attn":
            out["mixer"] = attention_specs(cfg)
        elif spec.mixer == "mamba":
            out["mixer"] = dict(ssm.MAMBA_SPECS)
        else:
            sp = dict(ssm.RWKV_SPECS)
            if not cfg.shard_heads_ok():
                sp = {k: tuple(None if a == "heads" else a for a in v) for k, v in sp.items()}
            out["mixer"] = sp
        out["mlp_norm"] = ("d_model",)
        if spec.mlp == "dense":
            out["mlp"] = dict(MLP_SPECS)
        elif spec.mlp == "moe":
            sp = dict(moe.MOE_SPECS)
            if not cfg.moe.dense_residual:
                sp.pop("dense", None)
            out["mlp"] = sp
        else:
            out["mlp"] = dict(ssm.RWKV_CM_SPECS)
        return out

    def param_specs(self) -> dict:
        """The tree of logical-axis tuples matching :meth:`init`'s, the
        reference's: a leading ``"layers"`` axis on the stacked block
        leaves, the embedding on ``vocab``, the LM head on ``(d_model,
        vocab)``."""
        specs: dict = {"embed": ("vocab", None), "final_norm": ("d_model",)}
        if not self.cfg.tie_embeddings:
            specs["lm_head"] = ("d_model", "vocab")

        def stacked(t):
            if isinstance(t, dict):
                return {k: stacked(v) for k, v in t.items()}
            return ("layers",) + tuple(t)

        specs["blocks"] = tuple(stacked(self._block_specs(s)) for s in self.cfg.pattern)
        return specs

    def cache_specs(self) -> dict:
        """Logical axes of the serving cache, the reference's."""
        cfg = self.cfg
        h = "heads" if cfg.shard_heads_ok() else None
        blocks = []
        for spec in cfg.pattern:
            if spec.mixer == "attn":
                kv = ("layers", "batch", "cache_seq", "kv_heads", None)
                blocks.append({"k": kv, "v": kv})
            elif spec.mixer == "mamba":
                blocks.append({"conv": ("layers", "batch", None, "cache_inner"),
                               "ssm": ("layers", "batch", "cache_inner", "state")})
            else:
                blocks.append({"state": ("layers", "batch", h, None, None),
                               "last": ("layers", "batch", None),
                               "cm_last": ("layers", "batch", None)})
        return {"pos": (), "blocks": tuple(blocks)}

    def cast_params(self, params: dict) -> dict:
        """The tree as the compute graph uses it: every leaf but the
        ``_KEEP_F32`` ones (and ``final_norm``, which ``rms_norm`` reads in
        f32) in the compute dtype.  Leaves already in it are not copied."""
        cd = self.flags.compute_dtype
        out = {k: v for k, v in params.items() if k != "blocks"}
        out["embed"] = params["embed"].to(cd)
        if "lm_head" in params:
            out["lm_head"] = params["lm_head"].to(cd)
        out["blocks"] = tuple(_cast_tree(b, cd) for b in params["blocks"])
        return out

    # ------------------------------------------------------------------ #
    # Caches
    # ------------------------------------------------------------------ #
    def cache_struct(self, batch: int, max_seq: int) -> dict:
        """The serving cache's ``(shape, dtype)`` tree."""
        cfg = self.cfg
        R = cfg.n_repeats
        blocks = []
        for spec in cfg.pattern:
            if spec.mixer == "attn":
                kv = ((R, batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim),
                      CACHE_DTYPE)
                blocks.append({"k": kv, "v": kv})
            elif spec.mixer == "mamba":
                blocks.append({k: ((R,) + s, dt)
                               for k, (s, dt) in ssm.mamba_cache_spec(cfg, batch).items()})
            else:
                c = {k: ((R,) + s, dt) for k, (s, dt) in ssm.rwkv_cache_spec(cfg, batch).items()}
                c["cm_last"] = ((R, batch, cfg.d_model), CACHE_DTYPE)
                blocks.append(c)
        return {"pos": ((), torch.int32), "blocks": tuple(blocks)}

    def init_cache(self, batch: int, max_seq: int, device=None) -> dict:
        """A zero cache on ``device``: the current CUDA device unless the
        caller names another (``"cpu"``); without CUDA and without a
        device it raises."""
        device = resolve_device(device)
        st = self.cache_struct(batch, max_seq)
        return {
            "pos": torch.zeros(st["pos"][0], dtype=st["pos"][1], device=device),
            "blocks": tuple(
                {k: torch.zeros(s, dtype=dt, device=device) for k, (s, dt) in b.items()}
                for b in st["blocks"]
            ),
        }

    # ------------------------------------------------------------------ #
    # Blocks
    # ------------------------------------------------------------------ #
    def _apply_block(self, spec: LayerSpec, bp: dict, x, sin, cos, mode: str, cache, pos):
        """One serving block (``mode`` ``"prefill"`` or ``"decode"``) ->
        ``x``: :func:`_block` with mixers (and the RWKV channel mix) that
        use the layer's slice of the serving cache.  ``cache``: for
        ``attn``, the ``{"k", "v"}`` ``(B, max_seq, KV, hd)`` buffers,
        filled at ``[:, :S]`` in prefill; for ``rwkv``, ``state``, ``last``
        and ``cm_last``, and for ``mamba``, ``conv`` and ``ssm``, read in
        decode and overwritten in both modes (the final states written by
        the kernels straight into the cache)."""
        cfg, flags = self.cfg, self.flags
        decode = mode == "decode"

        def attn(p, h):
            if decode:
                return attention_decode(p, h, cfg, pos, (cache["k"], cache["v"]), flags)[0]
            y, (k_raw, v_raw) = attention(p, h, cfg, sin, cos, flags)
            S = h.shape[1]
            cache["k"][:, :S] = k_raw.to(CACHE_DTYPE)
            cache["v"][:, :S] = v_raw.to(CACHE_DTYPE)
            return y

        def mamba(p, h):
            y, st = ssm.mamba_apply(p, h, cfg, cache if decode else None,
                                    state_out=cache["ssm"])
            cache["conv"].copy_(st["conv"])
            return y

        def rwkv(p, h):  # the final state goes straight into the cache
            y, st = ssm.rwkv_apply(p, h, cache if decode else None, state_out=cache["state"])
            cache["last"].copy_(st["last"])
            return y

        def rwkv_cm(p, h):
            last = cache["cm_last"].to(h.dtype) if decode else None
            y, cm_last = ssm.rwkv_channel_mix(p, h, last)
            cache["cm_last"].copy_(cm_last)
            return y, None

        mixer = {"attn": attn, "mamba": mamba, "rwkv": rwkv}[spec.mixer]
        mlp = rwkv_cm if spec.mlp == "rwkv_cm" else (
            lambda p, h: self._mlp(spec.mlp)(p, h, cfg, flags))
        return _block(mixer, mlp, cfg.norm_eps, bp, x)[0]

    def _run_layers(self, params: dict, x, sin, cos, mode: str, cache: Optional[dict], pos):
        """The repeated pattern, layer by layer, over the stacked slices ->
        (``x``, the blocks' auxiliary losses summed in layer order, f32, as
        the reference's scan carries them).  In ``"train"`` mode (no cache)
        each layer runs :func:`_train_block`, under the remat policy; its
        slice is cast to the compute dtype there, inside the autograd
        graph."""
        cfg, flags = self.cfg, self.flags
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = _REMAT.get(flags.remat_policy)
        for r in range(cfg.n_repeats):
            for pi, spec in enumerate(cfg.pattern):
                bp = _layer(params["blocks"][pi], r)
                if mode != "train":
                    x = self._apply_block(spec, bp, x, sin, cos, mode,
                                          _layer(cache["blocks"][pi], r), pos)
                    continue
                block = functools.partial(_train_block, _MIXERS[spec.mixer],
                                          self._mlp(spec.mlp), cfg, flags)
                if remat is None:
                    x, a = block(bp, x, sin, cos)
                else:
                    x, a = checkpoint(block, bp, x, sin, cos, use_reentrant=False, **remat)
                if a is not None:
                    aux = aux + a
        return x, aux

    # ------------------------------------------------------------------ #
    # Entry points
    # ------------------------------------------------------------------ #
    def _rope(self, seq_len: int, device):
        """(sin, cos) tables, or (None, None) for an attention-free stack."""
        cfg = self.cfg
        if not any(s.mixer == "attn" for s in cfg.pattern):
            return None, None
        positions = torch.arange(seq_len, device=device)
        return rope_table(positions, cfg.resolved_head_dim, cfg.rope_theta)

    def _embed(self, params: dict, tokens: torch.Tensor, frontend=None) -> torch.Tensor:
        """The token embeddings in the compute dtype, after the ``frontend``
        embeddings ``(B, prefix, D)`` when given."""
        return self._prepend(F.embedding(tokens, params["embed"]).to(self.flags.compute_dtype),
                             frontend)

    @staticmethod
    def _prepend(x: torch.Tensor, frontend) -> torch.Tensor:
        if frontend is None:
            return x
        return torch.cat([frontend.to(x.dtype), x], dim=1)

    def _head(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        w = params.get("lm_head")
        if w is None:
            w = params["embed"].T
        return torch.einsum("bsd,dv->bsv", x, w.to(x.dtype))

    def loss_fn(self, params: dict, batch: dict):
        """``batch`` ``{"tokens": (B, S) int}`` (and ``"frontend"`` ``(B, P,
        D)`` for a frontend family) -> ``(loss, {"ce", "aux"})``, the
        reference's ``loss_fn``: next-token cross entropy over the token
        positions ``0 .. S-2`` (after the ``P`` frontend rows) in f32, plus
        0.01 times the auxiliary loss
        (the MoE blocks' load-balance losses summed over the layers; 0
        without MoE).  ``params`` is the f32 master
        tree: the embedding row gather ``embed[tokens]``, each layer's
        slice and the tied head are cast to the compute dtype inside the
        graph, so ``torch.autograd`` reaches the masters.  Attention
        ``auto`` is dense up to ``dense_attn_max`` tokens and chunked
        beyond, as in the reference."""
        tokens = batch["tokens"]
        frontend = batch.get("frontend")
        prefix = 0 if frontend is None else frontend.shape[1]
        x = self._prepend(params["embed"][tokens.long()].to(self.flags.compute_dtype), frontend)
        S = x.shape[1]
        sin, cos = self._rope(S, x.device)
        x, aux = self._run_layers(params, x, sin, cos, "train", None, None)
        logits = self._head(params, x)
        ce = cross_entropy_loss(logits[:, prefix: S - 1], tokens[:, 1:])
        return ce + _AUX_LOSS_WEIGHT * aux, {"ce": ce, "aux": aux}

    def prefill(self, params: dict, tokens: torch.Tensor, max_seq: int, frontend=None):
        """tokens ``(B, S_tok)`` int32, after ``frontend`` ``(B, P, D)``
        when given -> (last-token logits ``(B, 1, V)``, the cache: the
        attention blocks' first ``S = P + S_tok`` K/V rows, the rwkv and
        mamba blocks' states (and last inputs, conv windows), ``pos =
        S``)."""
        p = self.cast_params(params)
        x = self._embed(p, tokens, frontend)
        B, S = x.shape[0], x.shape[1]
        sin, cos = self._rope(S, x.device)
        cache = self.init_cache(B, max_seq, x.device)
        x, _ = self._run_layers(p, x, sin, cos, "prefill", cache, None)
        logits = self._head(p, x[:, -1:, :])
        cache["pos"].fill_(S)
        return logits, cache

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor):
        """One new token per sequence, tokens ``(B, 1)`` int32 ->
        (logits ``(B, 1, V)``, ``cache``), the cache updated in place."""
        p = self.cast_params(params)
        pos = cache["pos"]
        x = self._embed(p, tokens)
        x, _ = self._run_layers(p, x, None, None, "decode", cache, pos)
        logits = self._head(p, x)
        pos.add_(1)
        return logits, cache
