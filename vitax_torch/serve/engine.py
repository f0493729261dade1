"""InferenceEngine: ViT eval forward over power-of-two batch buckets
(vitax/serve/engine.py, on PyTorch).

Requests are padded to the next bucket (1, 2, 4, ..., serve_max_batch), and
only buckets that `warmup` ran are served: `compile_count` is the number of
buckets warmed, and a batch for any other shape raises instead of taking a
first-call path in the middle of traffic. Params come from a consolidated
npz export (`from_npz`), a checkpoint epoch (`from_checkpoint`), a
state_dict (`from_state`) or any model the caller built
(vitax_torch/models/vit.py build_model, seeded init).

A quantized export (int8 or float8_e4m3, vitax/serve/quant.py) keeps its
weights quantized on the device. Its model runs the JAX engine's
QuantDense numerics when act-quant is on or the fused kernel is active
(always on the card: the dequant_matmul kernel at every Dense site), and
the dequantize-at-use numerics of the JAX engine's `predict_quant`
otherwise (the CPU's default). An MoE model (cfg.moe_experts > 0) never
takes the QuantDense path, as vitax's `_quant_model_mode` is False for
it: a quantized MoE export, or a checkpoint quantized on load, is
dequantized at load (codes times scales in float32, the numbers vitax's
`dequantize_tree` computes at use) into the float model.
"""

from __future__ import annotations

import itertools
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vitax_torch import faults
from vitax_torch.checkpoint.consolidate import load_npz, load_npz_raw
from vitax_torch.checkpoint.convert import params_from_jax
from vitax_torch.config import Config
from vitax_torch.models.vit import Quant, VisionTransformer, build_model
from vitax_torch.ops.attention import make_attention_impl
from vitax_torch.ops.dequant_matmul import fused_dequant_active, make_quant_matmul
from vitax_torch.platform import DeviceLike, resolve_device
from vitax_torch.train.step import prepare_images
from vitax_torch.utils.logging import master_print


def bucket_sizes(max_batch: int) -> Tuple[int, ...]:
    """Power-of-two buckets 1, 2, 4, ..., max_batch."""
    sizes = []
    b = 1
    while b <= max_batch:
        sizes.append(b)
        b *= 2
    return tuple(sizes)


def next_bucket(n: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket holding n requests (n must fit the largest bucket)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"batch of {n} exceeds the largest bucket {buckets[-1]} "
        f"(--serve_max_batch); the batcher never emits this")


def model_quant(cfg: Config, quant_dtype: str, device) -> Optional[Quant]:
    """How a model of `quant_dtype` weights computes on `device` (vitax
    _quant_model_mode): None for float weights; the QuantDense numerics
    through make_quant_matmul when act-quant is on or the fused kernel is
    active; else dequantize at use. On the card the kernel is always
    active, and --fused_dequant off raises. An MoE model has no quantized
    form (its exports are dequantized at load): asking for one raises."""
    if not quant_dtype:
        return None
    if cfg.moe_experts > 0:
        raise ValueError("an MoE model serves float weights (vitax's _quant_model_mode is False for MoE): "
                         "dequantize its quantized state at load")
    fused = fused_dequant_active(cfg, device)
    return Quant(quant_dtype, make_quant_matmul(cfg) if fused or cfg.serve_act_quant != "off" else None)


class PinnedStager:
    """Host-to-card copies of CPU tensors through `threads` pinned buffers
    of `chunk` bytes, each thread on its own stream. A pageable copy of a
    mapped export runs at one thread's memcpy rate: a 10 GB int8 export
    took 13.8-15.8 s that way and 6.9-8.6 s staged by four threads on an
    H100 80GB HBM3 at 700 W (python -m vitax_torch.tools.export_load_ab)."""

    def __init__(self, device: torch.device, threads: int = 4, chunk: int = 64 << 20):
        self.device = device
        self.buffers = [torch.empty(chunk, dtype=torch.uint8, pin_memory=True) for _ in range(threads)]
        self.streams = [torch.cuda.Stream(device) for _ in range(threads)]
        self.pool = ThreadPoolExecutor(threads, thread_name_prefix="vitax-torch-stage")

    def copy(self, t: torch.Tensor) -> torch.Tensor:
        src = t.contiguous().reshape(-1).view(torch.uint8)
        dst = torch.empty(t.shape, dtype=t.dtype, device=self.device)
        out = dst.reshape(-1).view(torch.uint8)
        n, chunk = len(self.buffers), self.buffers[0].numel()
        offsets = range(0, src.numel(), chunk)

        def work(w: int) -> None:
            buf, stream = self.buffers[w], self.streams[w]
            for o in offsets[w::n]:
                m = min(chunk, src.numel() - o)
                stream.synchronize()                  # the buffer's last copy has left it
                buf[:m].copy_(src[o:o + m])
                with torch.cuda.stream(stream):
                    out[o:o + m].copy_(buf[:m], non_blocking=True)
            stream.synchronize()

        list(self.pool.map(work, range(n)))
        return dst

    def close(self) -> None:
        self.pool.shutdown()


def npz_state(flat: Dict[str, torch.Tensor], scales: Dict[str, torch.Tensor],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """params_from_jax of a load_npz_raw export, leaf by leaf on `device`:
    each leaf is copied there (never aliased: a mapped export's tensors
    alias its file; to a card through PinnedStager) before its layout
    change (the transposes of a quantized 10B export take seconds on a card
    and tens on a host), and leaves `flat` and `scales` as it goes."""
    stager = PinnedStager(device) if device.type == "cuda" else None
    copy = stager.copy if stager is not None else (lambda t: t.to(device, copy=True))
    state: Dict[str, torch.Tensor] = {}
    try:
        for key in list(flat):
            leaf = copy(flat.pop(key))
            scale = {key: copy(scales.pop(key))} if key in scales else None
            state.update(params_from_jax({key: leaf}, scale))
    finally:
        if stager is not None:
            stager.close()
    return state


class InferenceEngine:
    """Bucketed eval-mode forward: uint8 (B, H, W, 3) images -> top-k.

    `predict` is called from the batcher's one worker thread; construction
    and warmup happen before the server takes traffic."""

    def __init__(self, cfg: Config, model: VisionTransformer, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.eval()
        # quantized weights: the dtype, the per-channel scales beside each
        # quantized weight ({state_dict name: (out,) float32}), and the
        # activation-quant and fused-kernel modes reported on /metrics
        self.quant_dtype = model.quant.dtype if model.quant is not None else ""
        self.scales: Dict[str, torch.Tensor] = {n: b for n, b in model.named_buffers() if n.endswith(".qscale")}
        quantized = bool(self.quant_dtype)
        self.act_quant = cfg.serve_act_quant if quantized else "off"
        self.fused_dequant = quantized and fused_dequant_active(cfg, self.device)
        self.topk = min(cfg.serve_topk, cfg.num_classes)
        self.buckets = bucket_sizes(cfg.serve_max_batch)
        self.ready = False
        self._warm: set = set()

    @property
    def compile_count(self) -> int:
        """Buckets warmed (the JAX engine's count of compiled programs)."""
        return len(self._warm)

    @property
    def weights_dtype(self) -> str:
        """The matmul weights' type as resident on the device: the quant
        dtype of a quantized engine, else the type of the largest param."""
        if self.quant_dtype:
            return self.quant_dtype
        largest = max(self.model.parameters(), key=lambda p: p.numel())
        return str(largest.dtype).replace("torch.", "")

    def param_bytes(self) -> int:
        """Device-resident parameter footprint in bytes: every param and
        quantized weight, and the scales (vitax: weight leaves plus the
        scale table)."""
        return sum(t.numel() * t.element_size()
                   for t in itertools.chain(self.model.parameters(), self.model.buffers()))

    @classmethod
    def from_state(cls, cfg: Config, state: Dict[str, torch.Tensor], device: DeviceLike = None,
                   quant_dtype: str = "") -> "InferenceEngine":
        """An engine over a state_dict of the port's layout (float, or
        quantized with `quant_dtype`); tensors already on `device` are used
        in place, so two engines can share one quantized state."""
        device = resolve_device(device)
        model = build_model(cfg, device, attention_impl=make_attention_impl(cfg, device), init=False,
                            quant=model_quant(cfg, quant_dtype, device))
        model.load_state_dict({k: v.to(device) for k, v in state.items()}, strict=True, assign=True)
        if device.type == "cuda":       # the storage the state replaced goes back: a fleet's replicas share a card
            torch.cuda.empty_cache()
        return cls(cfg, model, device)

    @classmethod
    def from_checkpoint(cls, cfg: Config, ckpt_dir: Optional[str] = None, epoch: Optional[int] = None,
                        device: DeviceLike = None) -> "InferenceEngine":
        """Serve the params of a checkpoint epoch (checkpoint/io.py; epoch
        None = the latest committed one under ckpt_dir, default
        cfg.ckpt_dir). Only the model's entries are read, so a probe's or
        a sharded checkpoint serves too. Under --serve_quant_dtype the
        weights are quantized on `device` as they load (consolidate.py's
        per-channel quantizer, as an export of that dtype holds them)."""
        from vitax_torch.checkpoint import io as ckpt_io
        from vitax_torch.serve.quant import dequantized_for_serve, quantize_params_for_serve
        device = resolve_device(device)
        ckpt_dir = ckpt_dir or cfg.ckpt_dir
        if epoch is None:
            epoch = ckpt_io.latest_epoch(ckpt_dir)
            if epoch is None:
                raise ValueError(f"no epoch checkpoint under {ckpt_dir}")
        state = {k: v.to(device) for k, v in ckpt_io.read_state(ckpt_dir, epoch, groups=("model",))["model"].items()}
        quant_dtype = cfg.serve_quant_dtype
        if quant_dtype and cfg.moe_experts > 0:     # the weights an export of that dtype dequantizes to
            state, quant_dtype = dequantized_for_serve(state, quant_dtype), ""
        elif quant_dtype:
            state = quantize_params_for_serve(state, quant_dtype)
        engine = cls.from_state(cfg, state, device, quant_dtype)
        master_print(f"serve: params from checkpoint {ckpt_dir} epoch {epoch}"
                     + (f" (quantized on load: {quant_dtype})" if quant_dtype else "")
                     + (f" (MoE: quantized to {cfg.serve_quant_dtype} and dequantized on load)"
                        if cfg.serve_quant_dtype and not quant_dtype else ""))
        return engine

    @classmethod
    def from_npz(cls, cfg: Config, path: str, device: DeviceLike = None) -> "InferenceEngine":
        """Load a consolidated .npz export (vitax/checkpoint/consolidate.py),
        either block layout, keeping each leaf's stored type. A quantized
        export's manifest is authoritative: --serve_quant_dtype only asserts
        it, and raises on an unquantized file or another dtype."""
        flat, scales, manifest = load_npz_raw(path, mapped=True)
        want = cfg.serve_quant_dtype
        if want and not manifest:
            raise ValueError(f"--serve_quant_dtype {want} but {path} has no __quant__ manifest; "
                             f"re-export with consolidate.py --dtype {want}")
        dtypes = sorted(set(manifest.values()))
        if len(dtypes) > 1 or (want and dtypes != [want]):
            raise ValueError(f"{path} is quantized to {dtypes}; --serve_quant_dtype asks for {want!r}")
        quant_dtype = dtypes[0] if dtypes else ""
        if quant_dtype and cfg.moe_experts > 0:
            engine = cls.from_state(cfg, params_from_jax(load_npz(path)), device)
            master_print(f"serve: params from consolidated export {path} (quantized: {quant_dtype}, "
                         f"{len(scales)} scaled leaves, dequantized at load: MoE)")
            return engine
        engine = cls.from_state(cfg, npz_state(flat, scales, resolve_device(device)), device, quant_dtype)
        master_print(f"serve: params from consolidated export {path}"
                     + (f" (quantized: {quant_dtype}, {len(scales)} scaled leaves)" if manifest else ""))
        return engine

    def warmup(self) -> Dict[int, float]:
        """Run every bucket once on zeros (first calls pay allocator and
        kernel-load set-up). Returns {bucket: seconds}."""
        timings = {}
        s = self.cfg.image_size
        for b in self.buckets:
            t0 = time.perf_counter()
            self._run(np.zeros((b, s, s, 3), np.uint8))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            timings[b] = time.perf_counter() - t0
            self._warm.add(b)
        self.ready = True
        master_print("serve: warmed buckets " + ", ".join(f"{b}:{t:.2f}s" for b, t in timings.items()))
        return timings

    @torch.inference_mode()
    def _run(self, images: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        x = torch.from_numpy(images).to(self.device)
        logits = self.model(prepare_images(x))
        probs = torch.softmax(logits.float(), dim=-1)
        top_p, top_i = torch.topk(probs, self.topk, dim=-1)
        return top_i.to(torch.int32).cpu().numpy(), top_p.cpu().numpy()

    def predict(self, images: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(n, H, W, 3) uint8 -> (top-k class ids (n, k) int32, top-k probs
        (n, k) float32). Pads to the next bucket and drops the padded rows.
        The `engine_predict` fault site fires first, before any work."""
        faults.fire("engine_predict")
        n = images.shape[0]
        bucket = next_bucket(n, self.buckets)
        if bucket not in self._warm:
            raise RuntimeError(f"bucket {bucket} not warmed up: call warmup() before serving")
        if n < bucket:
            padded = np.zeros((bucket,) + images.shape[1:], images.dtype)
            padded[:n] = images
            images = padded
        top_i, top_p = self._run(images)
        return top_i[:n], top_p[:n]
