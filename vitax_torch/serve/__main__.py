"""CLI entry: python -m vitax_torch.serve — load an npz export, warm up, serve HTTP.

    python -m vitax_torch.serve --npz full.npz [--device cpu] [--serve_port 8000] ...
    python -m vitax_torch.serve --npz int8.npz [--serve_quant_dtype int8] [--serve_act_quant int8] \
        [--fused_dequant auto|on|off]

Serves every export of vitax/checkpoint/consolidate.py: float32 and
bfloat16 (--dtype float32|bfloat16), and quantized int8 or float8_e4m3
weights (--dtype int8|float8_e4m3), which stay quantized on the device;
--serve_act_quant int8 quantizes activations too (int8 exports only). The
model shape flags must match the export (vitax_torch/config.py, the JAX
package's flag names). Runs on the CUDA card unless --device cpu is given;
without a card it exits non-zero. On the card a quantized export's matmuls
run the dequant_matmul kernel, and --fused_dequant off exits non-zero.
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
    from vitax_torch.platform import resolve_device
    from vitax_torch.serve.engine import InferenceEngine
    try:
        cfg = Config(**config_fields_from_namespace(ns)).validate()
        device = resolve_device(ns.device)
        engine = InferenceEngine.from_npz(cfg, ns.npz, device)
    except (RuntimeError, ValueError) as e:
        print(f"vitax_torch.serve: {e}", file=sys.stderr, flush=True)
        return 2

    from vitax_torch.serve.server import serve_forever
    serve_forever(cfg, engine)
    return 0


if __name__ == "__main__":
    sys.exit(main())
