"""Quickstart on the PyTorch port: build a diffusion cascade, train its
discriminator, route a batch of queries through it, and solve the
allocation MILP.

The port's counterpart of ``examples/quickstart.py``, with the same toy
cascade and steps; runs on CUDA unless ``--device cpu``.

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.config.base import DiffusionConfig
from repro_torch.core.cascade import DiffusionCascade
from repro_torch.core.confidence import DeferralProfile
from repro_torch.core.milp import solve_allocation
from repro_torch.device import resolve_device
from repro_torch.models.unet import init_unet
from repro_torch.serving.profiles import default_serving
from repro_torch.training.discriminator import train_discriminator


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. Two diffusion model variants: light (1-step) and heavy (8-step).
    light_cfg = DiffusionConfig(name="toy-turbo", image_size=16,
                                in_channels=3, base_channels=16,
                                channel_mults=(1, 2), num_res_blocks=1,
                                attn_resolutions=(8,), num_steps=1,
                                text_dim=32)
    heavy_cfg = DiffusionConfig(name="toy-sd", image_size=16, in_channels=3,
                                base_channels=32, channel_mults=(1, 2),
                                num_res_blocks=2, attn_resolutions=(8,),
                                num_steps=8, text_dim=32)
    light_params = init_unet(light_cfg, seed=1, device=dev)
    heavy_params = init_unet(heavy_cfg, seed=2, device=dev)

    # 2. Train the discriminator (real-vs-generated, paper §3.2).
    print("training discriminator ...")
    disc_params, disc_cfg, hist = train_discriminator(
        3, steps=80, batch_size=16, image_size=16, lr=3e-3, log_every=40,
        device=dev)
    print("  final acc:", hist[-1]["acc"])

    # 3. Run a batch of queries through the cascade (stages, cheapest
    # first).
    cascade = DiffusionCascade([(light_cfg, light_params),
                                (heavy_cfg, heavy_params)],
                               disc_cfg, disc_params, device=dev)
    prompts = np.zeros((8, 4), np.int32)
    with torch.inference_mode():
        result = cascade.run_batch(prompts, thresholds=0.5)
    print(f"confidences: {np.round(result.confidences, 3)}")
    print(f"deferred to heavy: {int(result.deferred.sum())}/8")

    # 4. Solve the resource-allocation MILP for 12 QPS on 16 workers.
    serving = default_serving("sdturbo", num_workers=16)
    profile = DeferralProfile(result.confidences.tolist() * 50)
    plan = solve_allocation(serving.cascade, serving, profile,
                            demand_qps=12.0)
    print(f"plan: workers={plan.workers}, batches={plan.batches}, "
          f"thresholds={tuple(round(t, 3) for t in plan.thresholds)}, "
          f"solved in {plan.solve_ms:.2f} ms")
    return {"history": hist, "confidences": result.confidences.tolist(),
            "deferred": int(result.deferred.sum()),
            "outputs_shape": list(result.outputs.shape),
            "workers": list(plan.workers), "batches": list(plan.batches),
            "thresholds": list(plan.thresholds)}


if __name__ == "__main__":
    main()
