"""CLI entry: python -m vitax_torch.train — train the ViT on one device.

    python -m vitax_torch.train --fake_data [--device cpu] [--num_blocks 8] [--batch_size 32] ...

The flags are the JAX package's (vitax_torch/config.py). Runs on the CUDA
card unless --device cpu is given; without a card it exits non-zero.
"""

from __future__ import annotations

import sys

from vitax_torch.config import Config, build_parser, config_fields_from_namespace


def main(argv=None) -> int:
    parser = build_parser()
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default cuda; cpu for hosts without a card)")
    ns = parser.parse_args(argv)
    try:
        cfg = Config(**config_fields_from_namespace(ns)).validate()
    except ValueError as e:
        print(f"vitax_torch.train: {e}", file=sys.stderr, flush=True)
        return 2

    from vitax_torch.ops.fused_optimizer import fused_optimizer_active
    from vitax_torch.platform import resolve_device
    try:
        device = resolve_device(ns.device)
        fused_optimizer_active(cfg, device)
    except (RuntimeError, ValueError) as e:
        print(f"vitax_torch.train: {e}", file=sys.stderr, flush=True)
        return 2

    from vitax_torch.train.loop import train
    train(cfg, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
