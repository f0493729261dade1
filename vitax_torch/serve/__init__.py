"""vitax_torch.serve — batched ViT inference on PyTorch: npz export ->
eval-mode forward over warmed buckets -> dynamic micro-batcher -> HTTP.

    python -m vitax_torch.serve --npz full.npz [--device cpu] ...
"""

from vitax_torch.serve.batcher import BatchResult, DynamicBatcher, QueueFull  # noqa: F401
from vitax_torch.serve.engine import InferenceEngine, bucket_sizes, next_bucket  # noqa: F401
from vitax_torch.serve.server import (  # noqa: F401
    BrownoutController,
    ServeMetrics,
    drain,
    serve_forever,
    start_server,
    stop_server,
)
