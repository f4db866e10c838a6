"""Train the cascade discriminator (paper §3.2) on the PyTorch port with
checkpointing, then calibrate the deferral profile f(t) and print the
threshold table.

The port's counterpart of ``examples/train_discriminator.py``; runs on
CUDA unless ``--device cpu``. The checkpoints are in the JAX package's
file format (``repro_torch.training.checkpoint``).

  PYTHONPATH=src python examples/train_discriminator_torch.py
  PYTHONPATH=src python examples/train_discriminator_torch.py --device cpu
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.core.confidence import DeferralProfile
from repro_torch.device import resolve_device
from repro_torch.models.efficientnet import confidence_score
from repro_torch.training.data import degraded_images, natural_images
from repro_torch.training.discriminator import train_discriminator


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="where the checkpoints go (default: a new "
                    "temporary directory)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ckpt_dir = args.checkpoint_dir or tempfile.mkdtemp(prefix="disc_ckpt_")
    params, cfg, hist = train_discriminator(
        0, steps=args.steps, batch_size=16, image_size=16, lr=3e-3,
        log_every=30, checkpoint_dir=ckpt_dir, device=dev)
    for h in hist:
        print(f"step {h['step']:4d}  loss {h['loss']:.4f}  "
              f"acc {h['acc']:.3f}")
    print("checkpoints in", ckpt_dir)

    def score(images):
        with torch.inference_mode():
            return confidence_score(params, cfg, torch.from_numpy(
                images).to(dev)).cpu().numpy()

    # calibrate f(t) from light-model outputs (degraded images stand in)
    rng = np.random.default_rng(0)
    scores = score(degraded_images(rng, 128, 16))
    profile = DeferralProfile(scores.tolist())
    print("\n threshold t -> deferral fraction f(t)")
    table = {}
    for t in (0.1, 0.3, 0.5, 0.7, 0.9):
        table[t] = profile.f(t)
        print(f"   {t:.1f}  ->  {table[t]:.3f}")
    real = score(natural_images(rng, 64, 16))
    print("mean confidence  real:", float(np.mean(real)),
          " fake:", float(scores.mean()))
    return {"history": hist, "checkpoint_dir": ckpt_dir, "f": table,
            "mean_real": float(np.mean(real)),
            "mean_fake": float(scores.mean())}


if __name__ == "__main__":
    main()
