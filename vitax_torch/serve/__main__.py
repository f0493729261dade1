"""CLI entry: python -m vitax_torch.serve — load an npz export, warm up, serve HTTP.

    python -m vitax_torch.serve --npz full.npz [--device cpu] [--serve_port 8000] ...

The model shape flags must match the export (vitax_torch/config.py, the
JAX package's flag names). Runs on the CUDA card unless --device cpu is
given; without a card it exits non-zero.
"""

from __future__ import annotations

import sys

from vitax_torch.config import Config, build_parser, config_fields_from_namespace


def main(argv=None) -> int:
    parser = build_parser()
    parser.add_argument("--npz", type=str, required=True,
                        help="consolidated .npz export to serve (vitax/checkpoint/consolidate.py)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to serve on (default cuda; cpu for hosts without a card)")
    ns = parser.parse_args(argv)
    cfg = Config(**config_fields_from_namespace(ns)).validate()

    from vitax_torch.platform import resolve_device
    try:
        device = resolve_device(ns.device)
    except RuntimeError as e:
        print(f"vitax_torch.serve: {e}", file=sys.stderr, flush=True)
        return 2

    from vitax_torch.serve.engine import InferenceEngine
    from vitax_torch.serve.server import serve_forever
    serve_forever(cfg, InferenceEngine.from_npz(cfg, ns.npz, device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
