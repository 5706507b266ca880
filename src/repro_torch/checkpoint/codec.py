"""Int8 (+delta) checkpoint codec.

The paper's waste scales as sqrt(C): halving checkpoint bytes cuts waste by
~29% of its checkpoint share.  Encoding:

* ``int8``        blockwise absmax quantization (block 256), 4x smaller
                  than f32 payloads (scales add ~1.6%);
* ``int8_delta``  quantize ``x - prev`` instead; between nearby optimizer
                  steps the delta has much smaller dynamic range, so the
                  same 8 bits carry ~256x finer resolution (lossy but
                  bounded by block absmax / 127).

A copy of the reference's ``repro/checkpoint/codec.py``: this numpy path
defines the file format.  The port's store encodes on the leaf's device
through :mod:`repro_torch.kernels.ops` (CUDA kernels on the card), whose
output is byte for byte what this module writes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["encode_array", "decode_array", "encode_tree", "decode_tree"]

_BLOCK = 256


def _pack(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    flat = x.reshape(-1).astype(np.float32)
    pad = (-flat.size) % _BLOCK
    if pad:
        flat = np.pad(flat, (0, pad))
    blocks = flat.reshape(-1, _BLOCK)
    scale = np.maximum(np.abs(blocks).max(axis=1) / 127.0, 1e-12).astype(np.float32)
    q = np.clip(np.round(blocks / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


def encode_array(
    x: np.ndarray, prev: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, Dict]:
    """Returns (payload bytes as a structured flat array, meta)."""
    base = x.astype(np.float32)
    mode = "int8"
    if prev is not None and prev.shape == x.shape:
        base = base - prev.astype(np.float32)
        mode = "int8_delta"
    q, scale = _pack(base)
    payload = np.concatenate([q.reshape(-1).view(np.uint8), scale.view(np.uint8)])
    meta = {
        "codec": mode,
        "dtype": str(x.dtype),
        "shape": list(x.shape),
        "n": int(x.size),
        "nblocks": int(scale.size),
    }
    return payload, meta


def decode_array(
    payload: np.ndarray, meta: Dict, prev: Optional[np.ndarray] = None
) -> np.ndarray:
    nblocks = meta["nblocks"]
    qn = nblocks * _BLOCK
    q = payload[:qn].view(np.int8).reshape(nblocks, _BLOCK)
    scale = payload[qn : qn + 4 * nblocks].view(np.float32)
    x = (q.astype(np.float32) * scale[:, None]).reshape(-1)[: meta["n"]]
    x = x.reshape(meta["shape"])
    if meta["codec"] == "int8_delta":
        if prev is None:
            raise ValueError("int8_delta payload needs the previous checkpoint")
        x = x + prev.astype(np.float32)
    return x.astype(meta["dtype"])


def encode_tree(flat: Dict[str, np.ndarray], prev: Optional[Dict] = None):
    out = {}
    for k, v in flat.items():
        p = prev.get(k) if prev else None
        out[k] = encode_array(np.asarray(v), p if p is None else np.asarray(p))
    return out


def decode_tree(enc: Dict, prev: Optional[Dict] = None):
    out = {}
    for k, (payload, meta) in enc.items():
        p = prev.get(k) if prev else None
        out[k] = decode_array(payload, meta, p if p is None else np.asarray(p))
    return out
