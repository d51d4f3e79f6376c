"""Checkpoint + objective conversion walkthrough (paper §2.6 / §8; port of
``examples/convert_checkpoint.py``).

Demonstrates the three conversion mechanisms:

1. **Eq. 20** — pretrained ImageNet-DDPM DiT → text-conditioned FM expert
   (transfer blocks/embeddings, re-init final layer, fresh text stack).
2. **Eq. 21** — runtime timestep mapping round(999·t) into the pretrained
   discrete embedding table.
3. **Eqs. 22–25 + §8.3** — inference-time ε→velocity conversion with the
   numerical safeguards, verified against the analytic identity on the
   linear path (v = ε − x̂0).

Runs on the card (the converted expert's forward through the port's
kernels); ``--device cpu`` runs the kernels' plain versions.  Random
numbers come from ``torch.Generator``s seeded with the reference's
integers: the Eq. 20 report and the Eq. 21 table are the reference's
lines, the norms other numbers.

  PYTHONPATH=src python -m repro_torch.examples.convert_checkpoint \\
      [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core.conversion import (ConversionConfig,
                                         convert_checkpoint,
                                         eps_to_velocity)
from repro_torch.core.schedules import get_schedule, to_ddpm_timestep
from repro_torch.models import dit as D
from repro_torch.models.config import dit_b2
from repro_torch.weights import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    def normal(seed: int, shape) -> torch.Tensor:
        return torch.randn(shape, generator=gen(seed), device=dev)

    # --- 1) Eq. 20: architecture-level checkpoint conversion ---------------
    print("=== Eq. 20: ImageNet-DDPM checkpoint -> text-conditioned FM "
          "expert")
    src_cfg = dit_b2(use_text=False).reduced(latent_size=8)  # "ImageNet DiT"
    dst_cfg = dit_b2().reduced(latent_size=8)                # text-conditioned
    pretrained = D.init(src_cfg, gen(0))
    template = D.init(dst_cfg, gen(1))
    params, report = convert_checkpoint(pretrained, template, gen=gen(2))
    for group, action in sorted(report.items()):
        print(f"  {group:18s} -> {action}")
    x = normal(0, (2, 8, 8, 4))
    out = D.apply(dst_cfg, params, x,
                  torch.tensor([0.3, 0.8], device=dev))
    print(f"  converted expert forward OK: {tuple(out.shape)}, "
          f"finite={bool(torch.isfinite(out).all())}")

    # --- 2) Eq. 21: runtime timestep compatibility -------------------------
    print("\n=== Eq. 21: continuous FM time -> discrete DiT table index")
    for t in (0.0, 0.123, 0.5, 1.0):
        idx = int(to_ddpm_timestep(torch.tensor([t], device=dev))[0])
        print(f"  t={t:5.3f} -> t_DiT={idx}")

    # --- 3) ε→v conversion with safeguards ---------------------------------
    print("\n=== Eqs. 22–25: schedule-aware ε→velocity conversion")
    lin, cos = get_schedule("linear"), get_schedule("cosine")
    x0 = torch.clamp(normal(0, (4, 8, 8, 4)), -3, 3)
    eps = normal(3, tuple(x0.shape))
    t = torch.tensor([0.2, 0.5, 0.8, 0.99], device=dev)
    for sch, name in ((lin, "linear"), (cos, "cosine")):
        xt = sch.perturb(x0, eps, t)
        v = eps_to_velocity(xt, eps, sch, t,
                            ConversionConfig(velocity_scaling="none"))
        if name == "linear":
            err = float(torch.max(torch.abs(v - (eps - x0))[:3]))
            print(f"  {name}: |v - (eps - x0)| = {err:.2e}  "
                  f"(Eq. 25 identity)")
        else:
            print(f"  {name}: velocity norms per t: "
                  f"{[float(torch.linalg.norm(v[i])) for i in range(4)]}")
    print("  safeguards: alpha_safe=max(alpha,0.01), x0 clamp ±20, "
          "Eq. 31 dampening at t>0.85 (enable with velocity_scaling="
          "'piecewise')")


if __name__ == "__main__":
    main()
