"""vitax_torch — the ViT of vitax on PyTorch and CUDA, for NVIDIA Hopper.

A port of the JAX package beside it (vitax/, the reference it is held
against). It never imports jax or vitax. Every Pallas kernel the JAX
package runs on a path that is ported here has a hand-written Hopper
kernel under csrc/, built with nvcc at first use.

Package map (mirrors vitax/):
  config        serve-path flags and Config, with the JAX names and defaults
  platform      device selection: the card unless the caller asks for the CPU
  models        the ViT as nn.Modules (eval forward)
  ops           the flash-attention forward kernel, its plain version, the nvcc build
  checkpoint    npz export reading and JAX -> torch param conversion
  data          the eval image transform
  train         on-device input normalisation
  serve         inference engine, dynamic batcher, HTTP server

Ported so far: the serve path. Training, quantized serving and the rest
are later slices (ROADMAP.md).
"""

__version__ = "0.1.0"
