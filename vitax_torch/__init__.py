"""vitax_torch — the ViT of vitax on PyTorch and CUDA, for NVIDIA Hopper.

A port of the JAX package beside it (vitax/, the reference it is held
against). It never imports jax or vitax. Every Pallas kernel the JAX
package runs on a path that is ported here has a hand-written Hopper
kernel under csrc/, built with nvcc at first use.

Package map (mirrors vitax/):
  config        flags and Config of the serve and train paths, with the JAX names and defaults
  platform      device selection: the card unless the caller asks for the CPU
  models        the ViT as nn.Modules (forward; per-block recompute when training)
  ops           flash-attention forward and backward, fused clip+AdamW, the
                dequant matmul: kernels, plain versions, dispatchers; the nvcc build
  checkpoint    train-state save, resume and pruning (torch.distributed.checkpoint
                with a commit marker), the npz export (quantized too) written
                and read, the per-channel weight quantizer, JAX <-> torch
                param and train-state conversion
  data          fake ImageNet, ImageFolder trees and .vtxshard streams, the train
                and val transforms, the native JPEG decoder's wrappers, the
                samplers and loaders
  _native       the host C++ decoder (decode.cc) and its g++ build
  train         schedule, state, train/eval steps, the loop and its CLI
  telemetry     model FLOPs and MFU
  serve         inference engine (float, int8 and fp8 weights), dynamic
                batcher, HTTP server, quantized-serving helpers and gate
  tools         the shard packer and the kernels' A/B and ladder tools

Ported so far: the serve path, single-card training on fake data, from
an ImageFolder tree or from streaming shards, quantized serving, dropout,
long context, and checkpoint, resume and export. FSDP and the rest are
later slices (ROADMAP.md).
"""

__version__ = "0.1.0"
