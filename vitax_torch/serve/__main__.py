"""CLI entry: python -m vitax_torch.serve — load params, warm up, serve HTTP.

    python -m vitax_torch.serve --npz full.npz [--device cpu] [--serve_port 8000] ...
    python -m vitax_torch.serve --npz int8.npz [--serve_quant_dtype int8] [--serve_act_quant int8] \
        [--fused_dequant auto|on|off]
    python -m vitax_torch.serve --ckpt_dir /ckpts [--epoch N] [--serve_quant_dtype int8] ...

Serves a checkpoint epoch of vitax_torch.train (--epoch -1, the default:
the latest committed one under --ckpt_dir; its params only, so a probe's
or a sharded checkpoint serves too; --serve_quant_dtype quantizes them on
load), or every export of vitax/checkpoint/consolidate.py: float32 and
bfloat16 (--dtype float32|bfloat16), and quantized int8 or float8_e4m3
weights (--dtype int8|float8_e4m3), which stay quantized on the device;
--npz overrides --ckpt_dir and --epoch. --serve_act_quant int8 quantizes
activations too (int8 weights only). The model shape flags must match the
export or checkpoint (vitax_torch/config.py, the JAX package's flag
names). Runs on the CUDA card unless --device cpu is given; without a card
it exits non-zero. On the card quantized weights run the dequant_matmul
kernel, and --fused_dequant off exits non-zero.
"""

from __future__ import annotations

import sys
import time

from vitax_torch.config import Config, build_parser, config_fields_from_namespace


def main(argv=None) -> int:
    parser = build_parser()
    parser.add_argument("--npz", type=str, default="",
                        help="consolidated .npz export to serve (vitax/checkpoint/consolidate.py); overrides "
                             "--ckpt_dir and --epoch")
    parser.add_argument("--epoch", type=int, default=-1,
                        help="checkpoint epoch to serve (-1 = the latest under --ckpt_dir)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to serve on (default cuda; cpu for hosts without a card)")
    ns = parser.parse_args(argv)
    from vitax_torch.platform import resolve_device
    from vitax_torch.programs.builder import build_engine
    try:
        cfg = Config(**config_fields_from_namespace(ns)).validate()
        device = resolve_device(ns.device)
        t0 = time.perf_counter()
        engine = build_engine(cfg, npz=ns.npz, epoch=None if ns.epoch < 0 else ns.epoch, device=device)
    except (FileNotFoundError, RuntimeError, ValueError) as e:
        print(f"vitax_torch.serve: {e}", file=sys.stderr, flush=True)
        return 2
    print(f"serve: params loaded onto {device} in {time.perf_counter() - t0:.1f}s", flush=True)

    from vitax_torch.serve.server import serve_forever
    serve_forever(cfg, engine)
    return 0


if __name__ == "__main__":
    sys.exit(main())
