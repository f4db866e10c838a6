"""Cluster mode: DiffServe workers as slices of the CUDA devices.

Port of ``WorkerSlice`` and ``ClusterRuntime`` in
``repro/serving/cluster.py``. ``measure_profile`` builds the per-tier
e(b) tables by timing the real cascade stages on the card (in place of
the paper's offline A100 profiling); ``serve_batch`` serves a batch of
queries through the cascade. The live control loop (``ClusterBackend``)
comes with the control plane it drives.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.config.base import LatencyProfile
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class WorkerSlice:
    """A slice of the devices assigned to one cascade tier. Worker
    classes, liveness and the heartbeat come with ``ClusterBackend``."""
    wid: int
    role: Optional[int] = None        # tier index; None while loading
    devices: tuple = ()


def _device_list(device: torch.device) -> List[torch.device]:
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_call(device: torch.device, fn, *args) -> float:
    """Wall seconds of one call, with the device drained on both sides."""
    _sync(device)
    t0 = time.perf_counter()
    fn(*args)
    _sync(device)
    return time.perf_counter() - t0


class ClusterRuntime:
    """Executes real batched cascade queries; measures execution
    profiles. ``num_workers`` / ``worker_tp_size`` / ``kernel_impl`` /
    ``batch_buckets`` are the serving knobs of the same names."""

    def __init__(self, cascade, *, num_workers: int = 1,
                 worker_tp_size: int = 1, kernel_impl: str = "auto",
                 batch_buckets: Sequence[int] = (1, 2, 4, 8),
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cascade = cascade
        if cascade.device != self.device:
            raise ValueError(f"cascade lives on {cascade.device}, runtime "
                             f"on {self.device}")
        cascade.configure_kernels(kernel_impl, batch_buckets)
        devs = _device_list(self.device)
        n = len(devs)
        tp = max(worker_tp_size, 1)
        # modular wrap: every slice gets exactly tp devices even when the
        # window passes the end of the device list (on one H100 every
        # slice is device 0)
        self.slices: List[WorkerSlice] = [
            WorkerSlice(wid=i, devices=tuple(devs[(i * tp + j) % n]
                                             for j in range(tp)))
            for i in range(num_workers)]
        self.last_stage_times: List[List[Tuple[int, float]]] = []


    def measure_profile(self, batches=(1, 2, 4), prompt_len: int = 8,
                        repeats: int = 2) -> List[LatencyProfile]:
        """Time each real cascade stage -> per-tier LatencyProfile fits
        (tier order matches ``cascade.stages``); the best-of-``repeats``
        seconds per (tier, batch) stay in ``last_stage_times``. Every
        (stage, batch) runs once untimed first (the kernel libraries are
        built and loaded at their first launch); a new batch shape during
        the timed repeats raises, since it would fold first-call time into
        service time."""
        stages = self.cascade.stage_fns()
        calls = [[(b, torch.zeros((b, prompt_len), dtype=torch.int64,
                                  device=self.device)) for b in batches]
                 for _ in stages]
        for (_, fn, params), row in zip(stages, calls):
            for _, toks in row:
                fn(params, toks)
        _sync(self.device)
        pre = self.cascade.shape_counts()
        out = []
        for (cfg, fn, params), row in zip(stages, calls):
            ts = []
            for b, toks in row:
                best = min(_time_call(self.device, fn, params, toks)
                           for _ in range(repeats))
                if self.cascade.shape_counts() != pre:
                    raise RuntimeError(
                        f"stage {getattr(cfg, 'name', cfg)} ran a new shape "
                        f"during timed repeats at batch {b}: the e(b) "
                        "profile would fold first-call time into service "
                        "time")
                ts.append((b, best))
            out.append(ts)
        self.last_stage_times = out
        return [_fit(ts) for ts in out]

    def serve_batch(self, prompt_tokens, thresholds):
        return self.cascade.run_batch(prompt_tokens, thresholds)


def _fit(ts: List[Tuple[int, float]]) -> LatencyProfile:
    """e(b) = base + marginal * (b - 1) through the first and last point."""
    base = ts[0][1]
    if len(ts) > 1:
        marg = max((ts[-1][1] - base) / (ts[-1][0] - 1), 1e-4)
    else:
        marg = base * 0.5
    return LatencyProfile(base_s=base, marginal_s=marg)
