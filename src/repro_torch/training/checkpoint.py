"""Atomic parameter-tree checkpoints in the JAX package's file format:
msgpack + zstd (or zlib), keep-N rotation, resume.

Port of ``repro/training/checkpoint.py``; a file either package writes
loads in the other. Layout: <dir>/step_<n>.ckpt, the ``REPROCKPT1``
magic, a one-byte codec tag, then the compressed msgpack payload
``{"leaves": [{"dtype", "shape", "data"}, ...], "extra": json, "step"}``.
Writes go to a temp file then ``os.replace`` (atomic on POSIX).

  * Leaves are stored in ``jax.tree_util.tree_flatten`` order
    (``repro_torch/tree.py``) and in the JAX package's layout: ``save``
    passes the tree through ``models.convert.to_jax`` (HWIO conv
    weights), ``load`` through ``from_jax``. An LM tree (a dict with
    ``"layers"``: the parameters, or AdamW's moments and scales over
    them) is stacked by the same two functions given its
    ``ModelConfig`` (``cfg=``), so an LM ``(params, opt_state)`` file
    loads in the JAX package's ``load`` and back (``AdamWState``
    flattens in field order: count, m, v, then the 8-bit scales). A
    bfloat16 leaf is written and read through a ``uint16`` view, so no
    ``ml_dtypes`` is needed.
  * ``zstandard`` is optional, as in the JAX package: saves compress
    with zstd where it imports and with stdlib ``zlib`` otherwise, and
    a zstd file needs ``zstandard`` to load.
  * The payload's msgpack subset (maps with bytes keys, arrays,
    non-negative ints, bin 8/16/32) has its own codec here, byte for
    byte ``msgpack.packb``/``unpackb``'s, so the package needs no
    ``msgpack``.
"""
from __future__ import annotations

import json
import os
import re
import struct
import tempfile
import zlib
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models.convert import from_jax, to_jax
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import unflatten

try:
    import zstandard
except ImportError:                       # optional, as in the JAX package
    zstandard = None

_MAGIC = b"REPROCKPT1"
_CODEC_ZSTD = b"Z"
_CODEC_ZLIB = b"L"


def _compress(payload: bytes) -> Tuple[bytes, bytes]:
    if zstandard is not None:
        return _CODEC_ZSTD, zstandard.ZstdCompressor(level=3).compress(payload)
    return _CODEC_ZLIB, zlib.compress(payload, 6)


def _decompress(codec: bytes, blob: bytes) -> bytes:
    if codec == _CODEC_ZLIB:
        return zlib.decompress(blob)
    if codec == _CODEC_ZSTD:
        if zstandard is None:
            raise ImportError(
                "checkpoint was written with zstd; install zstandard to "
                "load it (pip install zstandard)")
        return zstandard.ZstdDecompressor().decompress(blob)
    # pre-codec-tag files: the byte belongs to a zstd frame (0x28 B5 2F FD)
    if zstandard is None:
        raise ImportError(
            "legacy zstd checkpoint; install zstandard to load it")
    return zstandard.ZstdDecompressor().decompress(codec + blob)


# ---------------------------------------------------------------------------
# msgpack, the payload's subset
# ---------------------------------------------------------------------------
def _head(out: bytearray, n: int, fix: int, fix_max: int, tags) -> None:
    """A length (or value) header: the fix form below ``fix_max``, else
    the narrowest of ``tags`` ((tag, struct format, limit), ...)."""
    if n < fix_max:
        out.append(fix | n)
        return
    for tag, fmt, limit in tags:
        if n < limit:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: {n} is out of range")


_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARRAY = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))
_UINT = ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32),
         (0xCF, ">Q", 1 << 64))


def _pack(obj, out: bytearray) -> None:
    if isinstance(obj, bool) or not isinstance(obj, (int, bytes, list,
                                                     tuple, dict)):
        raise TypeError(f"msgpack subset: cannot pack {type(obj).__name__}")
    if isinstance(obj, int):
        if obj < 0:
            raise ValueError("msgpack subset: negative int")
        _head(out, obj, 0x00, 0x80, _UINT)
    elif isinstance(obj, bytes):
        _head(out, len(obj), 0, 0, _BIN)
        out += obj
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, _MAP)
        for k, v in obj.items():
            if not isinstance(k, bytes):
                raise TypeError("msgpack subset: map keys must be bytes")
            _pack(k, out)
            _pack(v, out)
    else:
        _head(out, len(obj), 0x90, 16, _ARRAY)
        for v in obj:
            _pack(v, out)


def packb(obj) -> bytes:
    """``msgpack.packb(obj)`` for the subset the payload uses."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _unpack(buf: memoryview, i: int):
    def take(fmt):
        (n,) = struct.unpack_from(fmt, buf, i + 1)
        return n, i + 1 + struct.calcsize(fmt)

    tag = buf[i]
    if tag < 0x80:                                   # positive fixint
        return tag, i + 1
    if 0x80 <= tag <= 0x8F:
        n, j = tag & 0x0F, i + 1
        kind = "map"
    elif 0x90 <= tag <= 0x9F:
        n, j = tag & 0x0F, i + 1
        kind = "array"
    else:
        fmt, kind = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"),
                     0xC6: (">I", "bin"), 0xCC: (">B", "uint"),
                     0xCD: (">H", "uint"), 0xCE: (">I", "uint"),
                     0xCF: (">Q", "uint"), 0xDC: (">H", "array"),
                     0xDD: (">I", "array"), 0xDE: (">H", "map"),
                     0xDF: (">I", "map")}.get(tag, (None, None))
        if fmt is None:
            raise ValueError(f"msgpack subset: unsupported tag 0x{tag:02x}")
        n, j = take(fmt)
    if kind == "uint":
        return n, j
    if kind == "bin":
        if j + n > len(buf):
            raise ValueError("msgpack: truncated bin")
        return bytes(buf[j:j + n]), j + n
    if kind == "array":
        items = []
        for _ in range(n):
            v, j = _unpack(buf, j)
            items.append(v)
        return items, j
    out = {}
    for _ in range(n):
        k, j = _unpack(buf, j)
        if not isinstance(k, bytes):
            raise ValueError("msgpack subset: map keys must be bytes")
        out[k], j = _unpack(buf, j)
    return out, j


def unpackb(data: bytes):
    """``msgpack.unpackb(data)`` for the subset the payload uses."""
    buf = memoryview(data)
    obj, end = _unpack(buf, 0)
    if end != len(buf):
        raise ValueError(f"msgpack: {len(buf) - end} trailing bytes")
    return obj


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------
def _pack_leaf(x) -> dict:
    t = torch.as_tensor(x).detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        name, data = "bfloat16", t.view(torch.uint16).numpy().tobytes()
    else:
        arr = t.numpy()
        name, data = str(arr.dtype), arr.tobytes()
    return {b"dtype": name.encode(), b"shape": list(t.shape), b"data": data}


def _unpack_leaf(d) -> torch.Tensor:
    name = d[b"dtype"].decode()
    shape = d[b"shape"]
    if name == "bfloat16":
        arr = np.frombuffer(d[b"data"], dtype=np.uint16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    arr = np.frombuffer(d[b"data"], dtype=np.dtype(name)).reshape(shape)
    return torch.from_numpy(arr.copy())


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------
def save(path: str, tree: Any, step: int, extra: Optional[dict] = None,
         keep: int = 3, cfg: Optional[ModelConfig] = None) -> str:
    """Save ``tree`` at <path>/step_<step>.ckpt in the JAX package's
    layout; rotate old checkpoints. ``cfg``: the model's config, needed
    where the tree holds an LM tree."""
    os.makedirs(path, exist_ok=True)
    payload = packb({
        b"leaves": [_pack_leaf(x) for x in
                    tree_leaves(to_jax(tree, cfg))],
        b"extra": json.dumps(extra or {}).encode(),
        b"step": step,
    })
    codec, comp = _compress(payload)
    final = os.path.join(path, f"step_{step}.ckpt")
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(_MAGIC)
            f.write(codec)
            f.write(comp)
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _rotate(path, keep)
    return final


def _rotate(path: str, keep: int):
    ckpts = sorted_steps(path)
    for step, f in ckpts[:-keep] if keep > 0 else []:
        os.unlink(os.path.join(path, f))


def sorted_steps(path: str):
    out = []
    for f in os.listdir(path):
        m = re.fullmatch(r"step_(\d+)\.ckpt", f)
        if m:
            out.append((int(m.group(1)), f))
    return sorted(out)


def latest_step(path: str) -> Optional[int]:
    steps = sorted_steps(path)
    return steps[-1][0] if steps else None


def load(path: str, tree_like: Any, step: Optional[int] = None,
         device: DeviceLike = None, cfg: Optional[ModelConfig] = None
         ) -> Tuple[Any, int, dict]:
    """Restore into the structure of ``tree_like`` (step=None: newest),
    in the port's layout on ``device`` (CUDA unless the caller passes
    "cpu"). ``cfg``: the model's config, needed where ``tree_like``
    holds an LM tree."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    fname = os.path.join(path, f"step_{step}.ckpt")
    with open(fname, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{fname}: bad magic")
        codec = f.read(1)
        payload = _decompress(codec, f.read())
    obj = unpackb(payload)
    stored = [_unpack_leaf(d) for d in obj[b"leaves"]]
    like = to_jax(tree_like, cfg)
    n = len(tree_leaves(like))
    if n != len(stored):
        raise ValueError(f"checkpoint has {len(stored)} leaves, expected "
                         f"{n}")
    tree = from_jax(unflatten(like, stored), device, cfg)
    extra = json.loads(obj[b"extra"].decode())
    return tree, obj[b"step"], extra
