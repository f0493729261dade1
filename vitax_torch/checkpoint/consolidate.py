"""The consolidated .npz export, written and read, and the per-channel
weight quantizer (vitax/checkpoint/consolidate.py).

The file is the JAX package's save_npz format, which save_npz here writes
too: "/"-joined Flax param paths
("params/blocks/attn/qkv/kernel", ...), bfloat16 leaves stored as uint16
bit-views listed under the "__bfloat16_keys__" manifest, and, for a
quantized export (--dtype int8 or float8_e4m3), a "__quant__" JSON manifest
naming the quantized leaves with their float32 per-output-channel scales at
"__scale__/<key>". fp8 leaves are stored as uint8 bit-views of
ml_dtypes.float8_e4m3 (max 240); every finite code of that type decodes to
the same value as torch.float8_e4m3fn, so they come back as e4m3fn views of
the stored bits, never re-quantized; the writer quantizes to 240, never to
e4m3fn's 448, so its codes are the JAX package's. This module reads,
writes and quantizes with numpy and torch only.

consolidate() exports a checkpoint of this package (checkpoint/io.py) in
the JAX layout (checkpoint/convert.py params_to_jax: scanned blocks, or
params/blocks_<i>/... under --no_scan_blocks, vitax's unscanned tree), so
either package's serving engine loads it:

    python -m vitax_torch.checkpoint.consolidate --ckpt_dir D --epoch N --out full.npz
    python -m vitax_torch.checkpoint.consolidate ... --full_state      # params, AdamW state, step
    python -m vitax_torch.checkpoint.consolidate ... --dtype bfloat16  # half-size export
    python -m vitax_torch.checkpoint.consolidate ... --dtype int8      # quantized export
    python -m vitax_torch.checkpoint.consolidate ... --no_scan_blocks  # params/blocks_<i>/...
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Iterable, Mapping, Optional, Tuple, Union

import numpy as np
import torch

BF16_MANIFEST_KEY = "__bfloat16_keys__"
# The quantized-export manifest: {"schema": 1, "dtypes": {dtype: [keys]}},
# each quantized leaf's float32 scales at QUANT_SCALE_PREFIX + key.
QUANT_MANIFEST_KEY = "__quant__"
QUANT_SCALE_PREFIX = "__scale__/"
QUANT_SCHEMA_VERSION = 1
QUANT_DTYPES = ("int8", "float8_e4m3")
# Leaves never quantized, by path name (the router and every LayerNorm),
# and the matmul weight leaf names that are.
QUANT_SKIP_NAMES = ("router", "norm", "norm1", "norm2")
QUANT_WEIGHT_NAMES = ("kernel", "w1", "w2")
# torch type of each quantized dtype's codes
QUANT_TORCH_DTYPES = {"int8": torch.int8, "float8_e4m3": torch.float8_e4m3fn}
# largest finite float8_e4m3 (ml_dtypes' IEEE-style e4m3: exponent 1111 is
# inf/NaN), so absmax maps onto it and no element rounds past it
_FP8_E4M3_MAX = 240.0
_FLOAT_DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64)

Leaf = Union[np.ndarray, torch.Tensor]


def flatten_tree(tree: dict, sep: str = "/") -> Dict[str, object]:
    """Flatten a nested-dict tree to {"a/b/c": leaf}; inverse of unflatten_tree."""
    out: Dict[str, object] = {}

    def walk(node, prefix):
        for key, value in node.items():
            path = f"{prefix}{sep}{key}" if prefix else str(key)
            if isinstance(value, dict):
                walk(value, path)
            else:
                out[path] = value

    walk(tree, "")
    return out


def unflatten_tree(flat: Dict[str, object], sep: str = "/") -> dict:
    """Rebuild the nested dict tree from flatten_tree's "/"-joined keys."""
    tree: dict = {}
    for key, leaf in flat.items():
        parts = key.split(sep)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def as_tensor(leaf: Leaf) -> torch.Tensor:
    """A numpy leaf as a CPU tensor sharing its memory (a copy of a
    read-only array, which torch would otherwise alias with a warning); a
    tensor as it is."""
    if isinstance(leaf, np.ndarray) and not leaf.flags.writeable:
        leaf = leaf.copy()
    return torch.as_tensor(leaf)


def _is_float(v: Leaf) -> bool:
    """Floating leaves only: integer and bool leaves (step counters, int8
    codes) are never touched by a --dtype cast."""
    return (v.dtype in _FLOAT_DTYPES if isinstance(v, torch.Tensor)
            else bool(np.issubdtype(v.dtype, np.floating)))


def should_quantize(key: str, v: Leaf) -> bool:
    """Whether a quantized export quantizes this leaf: a 2-D+ floating
    matmul weight (patchify, qkv, proj, MLP, head) not under a skip name."""
    parts = key.split("/")
    return (_is_float(v) and v.ndim >= 2
            and parts[-1] in QUANT_WEIGHT_NAMES
            and not any(p in QUANT_SKIP_NAMES for p in parts))


def _contraction_axes(key: str, ndim: int) -> Tuple[int, ...]:
    """Axes the absmax scale reduces: all but the output-channel (last) axis
    and the leading stacking axes (the scanned layer axis of "blocks"
    params, the experts axis of MoE w1/w2), so scales stay per
    (layer[, expert], out_channel)."""
    parts = key.split("/")
    stack = 1 if "blocks" in parts else 0
    if parts[-1] in ("w1", "w2"):
        stack += 1
    return tuple(range(stack, ndim - 1))


def quant_max(dtype: str) -> float:
    """127 for int8; the largest finite float8_e4m3, 240, for fp8."""
    if dtype not in QUANT_DTYPES:
        raise ValueError(f"unknown quantized dtype {dtype!r} (implemented: {QUANT_DTYPES})")
    return 127.0 if dtype == "int8" else _FP8_E4M3_MAX


@torch.no_grad()
def quantize_tensor(w: torch.Tensor, axes: Iterable[int], dtype: str = "int8"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax quantization of `w` over `axes` (keepdims scales),
    on w's device: scale = absmax / quant_max in float32, 1.0 for an
    all-zero channel; int8 rounds half to even and clips to [-127, 127],
    float8_e4m3 rounds to the nearest fp8 value (|w / scale| <= 240, where
    e4m3fn and the export's e4m3 agree code for code). quant_max divides as
    a tensor on w's device: a Python-number divisor becomes a multiply by
    its reciprocal on the card, whose scales then differ from the host's
    (and numpy's) in the last bit."""
    axes = tuple(axes)
    w = w.float()
    absmax = w.abs().amax(dim=axes, keepdim=True) if axes else w.abs()
    scale = absmax / torch.tensor(quant_max(dtype), dtype=torch.float32, device=w.device)
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    if dtype == "int8":
        q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    else:
        q = (w / scale).to(torch.float8_e4m3fn)
    return q, scale


def quantize_leaf(key: str, v: Leaf, dtype: str = "int8") -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel quantization of one leaf of the JAX layout (vitax
    quantize_leaf): (codes, float32 scales broadcastable to the leaf)."""
    t = as_tensor(v)
    return quantize_tensor(t, _contraction_axes(key, t.dim()), dtype)


def quantize_flat(flat: Mapping[str, Leaf], dtype: str = "int8"
                  ) -> Tuple[Dict[str, Leaf], Dict[str, torch.Tensor]]:
    """Quantize every eligible leaf of a flat JAX-layout tree: (flat with
    quantized leaves substituted, {key: float32 scales}); other leaves pass
    through untouched."""
    out: Dict[str, Leaf] = {}
    scales: Dict[str, torch.Tensor] = {}
    for k, v in flat.items():
        if should_quantize(k, v):
            out[k], scales[k] = quantize_leaf(k, v, dtype)
        else:
            out[k] = v
    return out, scales


def quant_manifest(keys: Iterable[str], dtype: str = "int8") -> str:
    """The dtype-keyed JSON manifest body for a set of quantized keys."""
    quant_max(dtype)
    return json.dumps({"schema": QUANT_SCHEMA_VERSION, "dtypes": {dtype: sorted(keys)}})


def parse_quant_manifest(doc: str) -> Dict[str, str]:
    """{key: quantized dtype} from a manifest JSON document."""
    parsed = json.loads(doc)
    if parsed.get("schema") != QUANT_SCHEMA_VERSION:
        raise ValueError(f"unknown quant manifest schema {parsed.get('schema')!r} "
                         f"(this build reads schema {QUANT_SCHEMA_VERSION})")
    out: Dict[str, str] = {}
    for dtype, keys in parsed.get("dtypes", {}).items():
        if dtype not in QUANT_DTYPES:
            raise ValueError(f"quantized dtype {dtype!r} not supported (implemented: {QUANT_DTYPES})")
        for k in keys:
            out[k] = dtype
    return out


def read_npz(path: str) -> Dict[str, np.ndarray]:
    """{name: array} of an .npz, as np.load reads it, but each stored
    (uncompressed) member mapped from the file copy-on-write instead of
    read through zipfile: a 10 GB export maps at once, and its pages load
    as they are used. Compressed members and object arrays go through
    np.load."""
    import mmap
    import struct
    import zipfile
    out: Dict[str, np.ndarray] = {}
    with open(path, "rb") as f, zipfile.ZipFile(f) as zf:
        infos = zf.infolist()
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if infos else None
        rest = []
        for info in infos:
            name = info.filename[:-len(".npy")] if info.filename.endswith(".npy") else info.filename
            if info.compress_type != zipfile.ZIP_STORED:
                rest.append(name)
                continue
            name_len, extra_len = struct.unpack("<HH", mm[info.header_offset + 26:info.header_offset + 30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            if dtype.hasobject:
                rest.append(name)
                continue
            out[name] = np.ndarray(shape, dtype, buffer=mm, offset=f.tell(), order="F" if fortran else "C")
    if rest:
        with np.load(path) as data:
            out.update({name: data[name] for name in rest})
    return out


def load_npz_raw(path: str, mapped: bool = False
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], Dict[str, str]]:
    """Read a save_npz export without dequantizing: (flat, scales, manifest)
    as CPU tensors. `flat` keeps every leaf at its stored type (bf16 from
    its uint16 view, int8 codes, fp8 codes as float8_e4m3fn views of the
    stored bits); `scales` are the float32 per-key scale arrays and
    `manifest` {key: quantized dtype}, both empty for an unquantized file.
    `mapped`: the tensors map the file (read_npz) and alias it until
    copied, so a caller that copies them at once (the serving engine, to
    its device) skips reading the file through zipfile."""
    if mapped:
        data = read_npz(path)
    else:
        with np.load(path) as npz:
            data = {k: npz[k] for k in npz.files}
    bf16 = (set(str(k) for k in data[BF16_MANIFEST_KEY])
            if BF16_MANIFEST_KEY in data else set())
    manifest = (parse_quant_manifest(str(data[QUANT_MANIFEST_KEY]))
                if QUANT_MANIFEST_KEY in data else {})
    flat: Dict[str, torch.Tensor] = {}
    scales: Dict[str, torch.Tensor] = {}
    for k in data:
        if k in (BF16_MANIFEST_KEY, QUANT_MANIFEST_KEY):
            continue
        arr = data[k]
        if not arr.flags.c_contiguous:      # (ascontiguousarray would make a 0-d leaf 1-d)
            arr = np.ascontiguousarray(arr)
        if k.startswith(QUANT_SCALE_PREFIX):
            scales[k[len(QUANT_SCALE_PREFIX):]] = torch.from_numpy(arr)
        elif k in bf16:
            flat[k] = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
        elif manifest.get(k) == "float8_e4m3":
            flat[k] = torch.from_numpy(arr.view(np.uint8)).view(torch.float8_e4m3fn)
        else:
            flat[k] = torch.from_numpy(arr)
    if set(manifest) != set(scales):
        raise ValueError(f"quant manifest/scale mismatch in {path}: "
                         f"{sorted(set(manifest) ^ set(scales))} without their pair")
    return flat, scales, manifest


def _npz_array(t: torch.Tensor) -> np.ndarray:
    """The array np.savez stores for a CPU tensor: bf16 as its uint16 bits,
    fp8 as its uint8 bits, anything else as it is."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def save_npz(out: str, flat: Mapping[str, Leaf], dtype: Optional[str] = None,
             scales: Optional[Mapping[str, Leaf]] = None) -> Dict[str, torch.Tensor]:
    """Write a flat tree (numpy arrays or CPU tensors) as the JAX package's
    .npz export, optionally casting or quantizing its floating leaves;
    returns the tree as written, as tensors.

    dtype "bfloat16" stores bf16 as uint16 bit-views listed under
    BF16_MANIFEST_KEY; "int8" / "float8_e4m3" quantize every eligible
    matmul weight per output channel (quantize_flat, fp8 to vitax's max of
    240) and record them under QUANT_MANIFEST_KEY with their float32 scales
    at QUANT_SCALE_PREFIX + key; fp8 codes are stored as uint8 bit-views.
    With `scales` ({key: scales}, as quantize_flat returns them) the leaves
    it names are codes of `dtype` quantized already (on the card, say) and
    are written as they are. Integer and bool leaves pass through every
    dtype unchanged."""
    tensors = {k: as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v) for k, v in flat.items()}
    if scales is not None:
        if dtype not in QUANT_DTYPES or not set(scales) <= set(tensors):
            raise ValueError(f"scales need a quantized dtype (got {dtype!r}) and codes for each of their keys")
        scales = {k: as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v) for k, v in scales.items()}
    elif dtype in QUANT_DTYPES:
        tensors, scales = quantize_flat(tensors, dtype)
    else:
        scales = {}
        if dtype:
            if dtype not in ("float32", "bfloat16"):
                raise ValueError(f"unknown export dtype {dtype!r} (float32, bfloat16, int8 or float8_e4m3)")
            target = getattr(torch, dtype)
            tensors = {k: v.to(target) if _is_float(v) else v for k, v in tensors.items()}
    payload = {k: _npz_array(v) for k, v in tensors.items()}
    bf16_keys = sorted(k for k, v in tensors.items() if v.dtype == torch.bfloat16)
    if bf16_keys:
        payload[BF16_MANIFEST_KEY] = np.asarray(bf16_keys)
    if scales:
        payload[QUANT_MANIFEST_KEY] = np.asarray(quant_manifest(scales, dtype))
        for k, sc in scales.items():
            payload[QUANT_SCALE_PREFIX + k] = sc.numpy()
    np.savez(out, **payload)
    return tensors


def save_npz_from_state(out: str, sd: Mapping[str, torch.Tensor], dtype: str) -> Dict[str, torch.Tensor]:
    """save_npz(out, params_to_jax(sd), dtype) for a quantized dtype, from a
    float state_dict of VisionTransformer that may sit on a card: the
    leaves are laid out as params_to_jax lays them (scanned blocks) and
    quantized on the state's device one block at a time (scales per layer
    and output channel, as over the stacked leaf), and only codes, scales
    and the other leaves come to the host, so neither the float tree nor a
    stacked float leaf is ever whole. Returns the tree as written."""
    from vitax_torch.checkpoint.convert import _jax_layout
    if dtype not in QUANT_DTYPES:
        raise ValueError(f"save_npz_from_state writes a quantized export ({QUANT_DTYPES}), not {dtype!r}")
    blocks: Dict[int, Dict[str, torch.Tensor]] = {}
    rest: Dict[str, torch.Tensor] = {}
    for name, t in sd.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            blocks.setdefault(int(parts[1]), {})[name] = t
        else:
            rest[name] = t
    flat: Dict[str, torch.Tensor] = {}
    scales: Dict[str, torch.Tensor] = {}
    for key, v in _jax_layout(rest, True).items():
        if should_quantize(key, v):
            q, sc = quantize_leaf(key, v, dtype)
            flat[key], scales[key] = q.contiguous().cpu(), sc.cpu()
        else:
            flat[key] = v.contiguous().cpu()
    layers: Dict[str, list] = {}
    layer_scales: Dict[str, list] = {}
    for i in sorted(blocks):
        for key, v in _jax_layout(blocks[i], False).items():
            key = key.replace(f"params/blocks_{i}/", "params/blocks/", 1)
            if should_quantize(key, v.unsqueeze(0)):
                q, sc = quantize_tensor(v, [a - 1 for a in _contraction_axes(key, v.dim() + 1)], dtype)
                layers.setdefault(key, []).append(q.contiguous().cpu())
                layer_scales.setdefault(key, []).append(sc.cpu())
            else:
                layers.setdefault(key, []).append(v.contiguous().cpu())
    for key, vs in layers.items():
        flat[key] = torch.stack(vs)
        if key in layer_scales:
            scales[key] = torch.stack(layer_scales[key])
    return save_npz(out, flat, dtype, scales=scales)


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    """Read a save_npz export back to {key: CPU tensor}, bf16 leaves restored
    and int8 / fp8 leaves dequantized to float32 (codes x scales); serving
    wants the quantized leaves as stored: load_npz_raw."""
    flat, scales, manifest = load_npz_raw(path)
    for k in manifest:
        flat[k] = flat[k].float() * scales[k]
    return flat


def consolidate(ckpt_dir: str, epoch: int, out: str, params_only: bool = True,
                dtype: Optional[str] = None, scanned: bool = True) -> Dict[str, torch.Tensor]:
    """Export the checkpoint of `epoch` (checkpoint/io.py) to one .npz in the
    JAX layout: the params ("params/...", blocks scanned, or
    "params/blocks_<i>/..." with scanned=False), or with params_only=False
    the whole train state in a JAX TrainState's keys. Returns the tree as
    written."""
    from vitax_torch.checkpoint import io as ckpt_io
    from vitax_torch.checkpoint.convert import params_to_jax, train_state_to_jax
    path = ckpt_io.epoch_ckpt_path(ckpt_dir, epoch)
    if params_only:
        tree = params_to_jax(ckpt_io.read_state(ckpt_dir, epoch, groups=("model",))["model"], scanned)
    else:
        st = ckpt_io.read_state(ckpt_dir, epoch)
        tree = train_state_to_jax(st["model"], st["mu"], st["nu"], st["step"], st["count"], scanned=scanned)
    flat = save_npz(out, tree, dtype=dtype)
    total = sum(v.numel() for v in flat.values())
    print(f"consolidated {len(flat)} arrays ({total:,} elements" + (f", cast to {dtype}" if dtype else "")
          + f") from {path} -> {out}", flush=True)
    return flat


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Export a vitax_torch checkpoint epoch to one .npz in the JAX "
                                            "package's layout (its serving engines and vitax_torch's load it)")
    p.add_argument("--ckpt_dir", type=str, required=True)
    p.add_argument("--epoch", type=int, required=True)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--full_state", action="store_false", dest="params_only",
                   help="include optimizer state and step, not just params")
    p.add_argument("--dtype", type=str, default=None, choices=["float32", "bfloat16", "int8", "float8_e4m3"],
                   help="cast float arrays for the export (default: keep the stored dtype); bfloat16 halves "
                        "the file; int8/float8_e4m3 quantize every matmul weight per output channel "
                        "(symmetric absmax, float32 scales under the __quant__ manifest), LN and bias "
                        "leaves stay f32")
    p.add_argument("--no_scan_blocks", action="store_false", dest="scan_blocks",
                   help="write vitax's unscanned layout (params/blocks_<i>/...) instead of the stacked blocks")
    args = p.parse_args(argv)
    consolidate(args.ckpt_dir, args.epoch, args.out, args.params_only, dtype=args.dtype, scanned=args.scan_blocks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
