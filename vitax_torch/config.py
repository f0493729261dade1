"""Configuration of the port's serve path: the fields it reads, with the
names, defaults and CLI flags of vitax/config.py (Config, build_parser,
validate), so one command line means the same model to both packages."""

from __future__ import annotations

import argparse
import dataclasses


@dataclasses.dataclass
class Config:
    # --- model shape (defaults = the 10.078B ViT) ---
    image_size: int = 224
    patch_size: int = 14
    embed_dim: int = 5120
    num_heads: int = 32
    num_blocks: int = 32
    mlp_ratio: float = 4.0
    num_classes: int = 1000

    # --- numerics and init ---
    seed: int = 0
    dtype: str = "bfloat16"             # compute dtype; initialized params are float32
    use_flash_attention: bool = True    # the Hopper flash-attention kernel on the card

    # --- serving ---
    serve_port: int = 8000              # HTTP port (0 = ephemeral, tests)
    serve_max_batch: int = 8            # largest power-of-two batch bucket
    max_batch_wait_ms: float = 5.0      # batcher flush deadline for the oldest queued request
    serve_topk: int = 5                 # classes returned per /predict response
    serve_queue_max: int = 1024         # batcher queue bound (0 = unbounded); full -> 503
    serve_request_timeout_s: float = 60.0  # a handler's wait on its batch future
    serve_brownout_enter_frac: float = 0.75  # degraded mode at this fraction of serve_queue_max (0 = off)
    serve_brownout_exit_frac: float = 0.25   # ... and back at or below this fraction
    serve_brownout_dwell_s: float = 2.0      # for this long, both ways
    serve_brownout_wait_ms: float = 1.0      # batcher deadline while degraded

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def mlp_hidden_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    def validate(self) -> "Config":
        """Reject settings the serve path cannot run; returns self."""
        checks = (
            (self.image_size % self.patch_size == 0,
             f"image_size {self.image_size} not divisible by patch_size {self.patch_size}"),
            (self.embed_dim % self.num_heads == 0,
             f"embed_dim {self.embed_dim} not divisible by num_heads {self.num_heads}"),
            (self.dtype in ("bfloat16", "float32"), f"unknown dtype {self.dtype!r}"),
            (0 <= self.serve_port <= 65535, f"--serve_port must be in [0, 65535], got {self.serve_port}"),
            (self.serve_max_batch >= 1 and self.serve_max_batch & (self.serve_max_batch - 1) == 0,
             f"--serve_max_batch must be a power of two >= 1, got {self.serve_max_batch}"),
            (self.max_batch_wait_ms >= 0, f"--max_batch_wait_ms must be >= 0, got {self.max_batch_wait_ms}"),
            (self.serve_topk >= 1, f"--serve_topk must be >= 1, got {self.serve_topk}"),
            (self.serve_queue_max >= 0, f"--serve_queue_max must be >= 0, got {self.serve_queue_max}"),
            (self.serve_request_timeout_s > 0,
             f"--serve_request_timeout_s must be > 0, got {self.serve_request_timeout_s}"),
            (0.0 <= self.serve_brownout_enter_frac <= 1.0,
             f"--serve_brownout_enter_frac must be in [0, 1], got {self.serve_brownout_enter_frac}"),
            (self.serve_brownout_enter_frac == 0
             or 0.0 <= self.serve_brownout_exit_frac <= self.serve_brownout_enter_frac,
             f"--serve_brownout_exit_frac must be in [0, {self.serve_brownout_enter_frac}], "
             f"got {self.serve_brownout_exit_frac}"),
            (self.serve_brownout_dwell_s >= 0,
             f"--serve_brownout_dwell_s must be >= 0, got {self.serve_brownout_dwell_s}"),
            (self.serve_brownout_wait_ms >= 0,
             f"--serve_brownout_wait_ms must be >= 0, got {self.serve_brownout_wait_ms}"),
        )
        for ok, msg in checks:
            if not ok:
                raise ValueError(msg)
        return self


def build_parser() -> argparse.ArgumentParser:
    """The serve path's flags, spelled as in vitax/config.py build_parser."""
    d = Config()
    parser = argparse.ArgumentParser(description="vitax_torch: the ViT on PyTorch and CUDA")
    for name in ("image_size", "patch_size", "embed_dim", "num_heads", "num_blocks",
                 "mlp_ratio", "num_classes", "seed", "serve_port", "serve_max_batch",
                 "max_batch_wait_ms", "serve_topk", "serve_queue_max", "serve_request_timeout_s",
                 "serve_brownout_enter_frac", "serve_brownout_exit_frac",
                 "serve_brownout_dwell_s", "serve_brownout_wait_ms"):
        default = getattr(d, name)
        parser.add_argument(f"--{name}", type=type(default), default=default)
    parser.add_argument("--dtype", type=str, default=d.dtype, choices=["bfloat16", "float32"])
    parser.add_argument("--no_flash_attention", action="store_false", dest="use_flash_attention")
    return parser


def config_fields_from_namespace(ns: argparse.Namespace) -> dict:
    """Config kwargs from a parsed namespace that may carry extra flags."""
    return {f.name: getattr(ns, f.name) for f in dataclasses.fields(Config)}
