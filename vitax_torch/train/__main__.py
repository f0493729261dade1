"""CLI entry: python -m vitax_torch.train — train the ViT on one device,
or sharded over one card per process under torchrun.

    python -m vitax_torch.train --fake_data [--device cpu] [--num_blocks 8] [--batch_size 32] ...
    torchrun --nproc_per_node N -m vitax_torch.train --fake_data ... [--no_reshard_after_forward]
        [--run_without_fsdp]

The flags are the JAX package's (vitax_torch/config.py). Runs on the CUDA
card unless --device cpu is given (each rank on cuda:LOCAL_RANK under
torchrun, over NCCL; with --device cpu over gloo); without a card it exits
non-zero.
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

    from vitax_torch import distributed
    from vitax_torch.ops.fused_optimizer import fused_optimizer_active
    try:
        device = distributed.maybe_initialize(ns.device)
        fused_optimizer_active(cfg, device)
    except (RuntimeError, ValueError) as e:
        print(f"vitax_torch.train: {e}", file=sys.stderr, flush=True)
        return 2

    from vitax_torch.train.loop import train
    train(cfg, device)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
