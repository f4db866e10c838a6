"""Device dispatch for every kernel of the ported serving paths.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor
launches the hand-written kernel, or raises. No path falls back from a
kernel to its plain version. Each kernel wrapper keeps a plain integer
launch counter (``<wrapper>.launches``), moved only where the kernel is
launched; ``launch_counts``/``reset_launch_counts`` read and zero them,
and a kernel with more than one route counts per route as well
(``route_counts``). No kernel has a backward, so on CUDA a call that
autograd would differentiate (grad mode on, an input that requires
grad) raises and names the ``"unfused"`` route (``needs_grad``);
``pick(name, impl)`` gives a model the function of that route: the
plain version, which autograd differentiates on any device.

A ``meta`` tensor (the dry run's shapes, ``launch/dryrun.py``) takes a
shape-only branch: an empty output of the kernel's shape and dtype, no
arithmetic, no launch. Under an ``analysis.count.Count`` each
dispatcher adds its kernel's work (``WORK``) and runs its call
uncounted, so a call counts the same on the CPU, the card and ``meta``.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from repro_torch.analysis import count as _count
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fused_groupnorm as _gn
from repro_torch.kernels import fused_rmsnorm as _rms
from repro_torch.kernels import mamba_scan as _mamba
from repro_torch.kernels import mlstm_chunk as _mlstm
from repro_torch.kernels import ref
from repro_torch.kernels import swiglu as _swiglu
from repro_torch.kernels.impls import resolve_kernel_impl
from repro_torch.parallel import local_calls

KERNELS = {"flash_attention": _flash.flash_attention,
           "fused_groupnorm": _gn.fused_groupnorm,
           "decode_attention": _decode.decode_attention,
           "fused_rmsnorm": _rms.fused_rmsnorm,
           "swiglu": _swiglu.swiglu,
           "mlstm_chunk": _mlstm.mlstm_chunk,
           "mamba_scan": _mamba.mamba_scan}
# the kernels with more than one route, each counting its launches by
# route (``route_counts``)
ROUTED = {"flash_attention": _flash.flash_attention,
          "mlstm_chunk": _mlstm.mlstm_chunk,
          "mamba_scan": _mamba.mamba_scan}
# each kernel's plain PyTorch version: what a CPU tensor runs, and what
# a kernel is held against on the card
PLAIN = {"flash_attention": ref.flash_attention_ref,
         "fused_groupnorm": ref.groupnorm_silu_ref,
         "decode_attention": ref.decode_attention_ref,
         "fused_rmsnorm": ref.rmsnorm_ref,
         "swiglu": ref.swiglu_ref,
         "mlstm_chunk": ref.mlstm_chunk_ref,
         "mamba_scan": ref.mamba_scan_ref}


def _bytes(*tensors) -> int:
    return _count.tensor_bytes(list(tensors))


# each kernel's work in one call, (dot flops, traffic bytes), for
# ``analysis.count``: the flops are what the count gives the plain
# version (2·M·N·K of its products: attention's two over every key row,
# the recurrences' per step); the bytes are 2 x what the kernel writes
# (its outputs and the states it updates in place), the JAX package's
# rule for a kernel call. Its plain version's own bytes follow how
# einsum lowers for the operands' strides, which no formula of shapes
# can repeat.
def _flash_work(q, k, v, **_):
    B, Sq, H, D = q.shape
    return 4.0 * B * H * Sq * k.shape[1] * D, 2 * _bytes(q)


def _decode_work(q, k, v, valid_len, *, with_lse=False):
    B, H, D = q.shape
    lse = B * H * 4 if with_lse else 0
    return 4.0 * B * H * k.shape[1] * D, 2 * (_bytes(q) + lse)


def _groupnorm_work(x, scale, bias, **_):
    return 0.0, 2 * _bytes(x)


def _rmsnorm_work(x, scale, *, residual=None, eps=1e-5):
    return 0.0, 2 * _bytes(x) * (1 if residual is None else 2)


def _swiglu_work(gate, up):
    return 0.0, 2 * _bytes(gate)


# the mLSTM at the shapes it is given: on a mesh a rank's local call
# (``local_calls``: its heads, or one head's share of the value columns)
def _mlstm_work(q, k, v, i_pre, f_pre, C, n, m):
    B, T, H, dk = q.shape
    dv = v.shape[-1]
    h = B * T * H * dv * _count.dtype_bytes(v.dtype)
    return 2.0 * T * B * H * dk * (dv + 1), 2 * (h + _bytes(C, n, m))


def _mamba_work(u, dt, A, B, C, D, h):
    Bt, T, E = u.shape
    return 2.0 * T * Bt * E * A.shape[1], 2 * _bytes(u, h)


WORK = {"flash_attention": _flash_work,
        "fused_groupnorm": _groupnorm_work,
        "decode_attention": _decode_work,
        "fused_rmsnorm": _rmsnorm_work,
        "swiglu": _swiglu_work,
        "mlstm_chunk": _mlstm_work,
        "mamba_scan": _mamba_work}


def _counted(name: str):
    """A dispatcher that, under an active ``Count``, adds ``WORK[name]``
    of its call and runs the call uncounted."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            c = _count.active()
            if c is None:
                return fn(*args, **kwargs)
            with c.kernel(*WORK[name](*args, **kwargs), name):
                return fn(*args, **kwargs)
        return call
    return wrap


def _device_type(t: torch.Tensor, kernel: str) -> str:
    """The branch ``t`` takes: "cuda" (the kernel), "cpu" (its plain
    version) or "meta" (shapes only); any other device raises."""
    kind = t.device.type
    if kind not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{kernel}: no kernel for device {t.device}")
    return kind


def needs_grad(*tensors) -> bool:
    """Whether autograd would have to differentiate through a call on
    ``tensors``: grad mode on and an input that requires grad."""
    return torch.is_grad_enabled() and any(
        torch.is_tensor(t) and t.requires_grad for t in tensors)


def _refuse_grad(kernel: str, *tensors) -> None:
    """No kernel has a backward, and a kernel's output has no
    ``grad_fn``: on CUDA, a call that autograd would differentiate
    raises instead of training nothing through it."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward; run the model on "
            "the 'unfused' route (kernel_impl / impl='unfused') to train "
            "through it")


@_counted("flash_attention")
def flash_attention(q, k, v, *, causal: bool = True,
                    kv_len: Optional[int] = None, q_offset: int = 0,
                    q_positions=None):
    """q: (B,Sq,H,D); k, v: (B,Sk,KH,D); query row r at position
    ``q_offset + r``, or at ``q_positions[b, r]`` ((B, Sq) int32) where
    given. See ``ref.flash_attention_ref``."""
    kind = _device_type(q, "flash_attention")
    if kind == "meta":
        return torch.empty_like(q)
    if kind == "cpu":           # contiguous, as the kernel writes it
        return ref.flash_attention_ref(q, k, v, causal=causal, kv_len=kv_len,
                                       q_offset=q_offset,
                                       q_positions=q_positions).contiguous()
    _refuse_grad("flash_attention", q, k, v)
    return _flash.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal,
                                  kv_len=kv_len, q_offset=q_offset,
                                  q_positions=q_positions)


@_counted("fused_groupnorm")
def fused_groupnorm(x, scale, bias, *, groups: int, act: bool = True,
                    eps: float = 1e-5):
    """x: (B, ..., C) channels-last. See ``ref.groupnorm_silu_ref``."""
    kind = _device_type(x, "fused_groupnorm")
    if kind == "meta":
        return torch.empty_like(x)
    if kind == "cpu":
        return ref.groupnorm_silu_ref(x, scale, bias, groups=groups, eps=eps,
                                      act=act)
    _refuse_grad("fused_groupnorm", x, scale, bias)
    return _gn.fused_groupnorm(x.contiguous(), scale, bias, groups=groups,
                               act=act, eps=eps)


@_counted("decode_attention")
def decode_attention(q, k, v, valid_len, *, with_lse: bool = False):
    """q: (B,H,D) one token; k, v: (B,T,KH,D); valid_len: (B,) int32.
    With ``with_lse`` returns (out, lse (B, H) float32). See
    ``ref.decode_attention_ref``."""
    kind = _device_type(q, "decode_attention")
    if kind == "meta":
        out = torch.empty_like(q)
        return (out, q.new_empty(q.shape[:2], dtype=torch.float32)) \
            if with_lse else out
    if kind == "cpu":           # contiguous, as the kernel writes it
        out = ref.decode_attention_ref(q, k, v, valid_len, with_lse=with_lse)
        return (out[0].contiguous(), out[1]) if with_lse \
            else out.contiguous()
    _refuse_grad("decode_attention", q, k, v)
    return _decode.decode_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), valid_len.contiguous(),
                                    with_lse=with_lse)


@_counted("fused_rmsnorm")
def fused_rmsnorm(x, scale, *, residual=None, eps: float = 1e-5):
    """x: (..., D). With ``residual``, returns ``(normed, x + residual)``.
    See ``ref.rmsnorm_ref``."""
    kind = _device_type(x, "fused_rmsnorm")
    if kind == "meta":
        return torch.empty_like(x) if residual is None else (
            torch.empty_like(x), torch.empty_like(x))
    if kind == "cpu":
        return ref.rmsnorm_ref(x, scale, eps=eps, residual=residual)
    _refuse_grad("fused_rmsnorm", x, scale, residual)
    return _rms.fused_rmsnorm(
        x.contiguous(), scale.contiguous(), eps=eps,
        residual=None if residual is None else residual.contiguous())


@_counted("swiglu")
def swiglu(gate, up):
    """silu(gate) * up. See ``ref.swiglu_ref``."""
    kind = _device_type(gate, "swiglu")
    if kind == "meta":
        return torch.empty_like(gate)
    if kind == "cpu":
        return ref.swiglu_ref(gate, up)
    _refuse_grad("swiglu", gate, up)
    return _swiglu.swiglu(gate.contiguous(), up.contiguous())


@_counted("mlstm_chunk")
def mlstm_chunk(q, k, v, i_pre, f_pre, C, n, m):
    """The mLSTM recurrence from state (C, n, m), which is overwritten
    with the final state; returns h in v's dtype. See
    ``ref.mlstm_chunk_ref``."""
    kind = _device_type(q, "mlstm_chunk")
    if kind == "meta":
        return v.new_empty(q.shape[:-1] + v.shape[-1:])
    if kind == "cpu":
        return ref.mlstm_chunk_ref(q, k, v, i_pre, f_pre, C, n, m)
    _refuse_grad("mlstm_chunk", q, k, v, i_pre, f_pre, C, n, m)
    return _mlstm.mlstm_chunk(q.contiguous(), k.contiguous(),
                              v.contiguous(), i_pre.contiguous(),
                              f_pre.contiguous(), C, n, m)


@_counted("mamba_scan")
def mamba_scan(u, dt, A, B, C, D, h):
    """The selective scan from state h, which is overwritten with the
    final state; returns y in u's dtype. B and C go to the kernel as they
    are (column slices of one projection are taken without a copy). See
    ``ref.mamba_scan_ref``."""
    kind = _device_type(u, "mamba_scan")
    if kind == "meta":
        return torch.empty_like(u)
    if kind == "cpu":
        return ref.mamba_scan_ref(u, dt, A, B, C, D, h)
    _refuse_grad("mamba_scan", u, dt, A, B, C, D, h)
    return _mamba.mamba_scan(u.contiguous(), dt.contiguous(),
                             A.contiguous(), B, C, D.contiguous(), h)


def pick(name: str, impl: str = "fused", adapt=None):
    """The function a model's call of kernel ``name`` takes on route
    ``impl`` (``kernels/impls.py``): ``fused`` this module's dispatcher
    (read when called, so a swapped module attribute is seen), ``unfused``
    the plain version (``PLAIN``) on any device. No kernel has a
    backward, so the train steps take ``unfused``: what the JAX package's
    train steps compute, through plain ops that autograd differentiates.
    ``adapt``, where given, wraps that function first (the mLSTM's call
    with its heads folded, ``xlstm.mlstm_scan``). Given DTensors (a step
    built on a mesh, ``launch/steps.py``) it runs on their local shards
    (``parallel/local_calls.py``)."""
    fn = PLAIN[name] if resolve_kernel_impl(impl) == "unfused" \
        else globals()[name]
    return local_calls.maybe_local(name, fn if adapt is None else adapt(fn))


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def offset_launches(way: Optional[str] = None) -> int:
    """Flash attention's launches with a query offset (``q_offset`` > 0,
    a prompt chunk at ``cache_index`` > 0): in total, or on route
    ``way``."""
    fn = _flash.flash_attention
    return fn.offset_launches if way is None \
        else fn.offset_route_launches[way]


def position_launches(way: Optional[str] = None) -> int:
    """Flash attention's launches with a query-position tensor (a
    forward given positions, or a prompt chunk at a tensor
    ``cache_index``): in total, or on route ``way``."""
    fn = _flash.flash_attention
    return fn.position_launches if way is None \
        else fn.position_route_launches[way]


def route_counts(kernel: str = "flash_attention") -> Dict[str, int]:
    """Launches by route of a kernel with more than one (``ROUTED``):
    flash attention's (the default) at head dims 64 and 128 ``wgmma``
    (bf16) and ``tf32x3`` (float32), ``cuda_core`` for the rest; the
    mLSTM's ``chunkwise`` (T > 1) and ``recurrent`` (T = 1); the
    selective scan's ``scan`` (T > 1) and ``step`` (T = 1)."""
    return dict(ROUTED[kernel].route_launches)


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for fn in ROUTED.values():
        for way in fn.route_launches:
            fn.route_launches[way] = 0
    _flash.flash_attention.offset_launches = 0
    _flash.flash_attention.position_launches = 0
    for counts in (_flash.flash_attention.offset_route_launches,
                   _flash.flash_attention.position_route_launches):
        for way in counts:
            counts[way] = 0
