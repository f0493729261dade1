"""ImageFolder dataset (vitax/data/imagefolder.py): a class per
subdirectory -> (image, label), as torchvision's ImageFolder lists it:
classes are the sorted subdirectory names of the split root, samples the
images under each in sorted walk order, labels the class indices.

`use_native=None` (auto) decodes JPEGs through the native library
(data/native.py) when it builds here; True asks for it, False for PIL.
Anything else (PNG and the other formats, a corrupt file) goes through PIL
item by item. `load_batch` decodes a whole batch in one GIL-free C++ call.
`decoded` counts the items each path decoded, so a run can show which
path fed it. PIL is imported at use.
"""

from __future__ import annotations

import io
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from vitax_torch.data import native
from vitax_torch.telemetry.threads import reporting

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp")


def list_imagefolder(root: str) -> Tuple[List[str], List[Tuple[str, int]]]:
    """(classes, [(path, label), ...]) in ImageFolder's order: the dataset's
    index order, and the record order of the packed shards
    (vitax_torch/tools/make_shards.py)."""
    if not os.path.isdir(root):
        raise FileNotFoundError(f"ImageFolder split directory not found: {root}")
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise FileNotFoundError(f"no class subdirectories under {root}")
    samples = []
    for label, cls in enumerate(classes):
        for dirpath, _, filenames in sorted(os.walk(os.path.join(root, cls))):
            samples += [(os.path.join(dirpath, f), label) for f in sorted(filenames)
                        if f.lower().endswith(IMG_EXTENSIONS)]
    if not samples:
        raise FileNotFoundError(f"no images found under {root}")
    return classes, samples


class DecodeCounts:
    """Items decoded by each path ("native", "pil", and the server's "ppm"),
    and "pil_jpeg", the JPEGs among the PIL items; under a lock, since the
    loader's threads share it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = {"native": 0, "pil": 0, "pil_jpeg": 0}

    def add(self, path: str, n: int = 1, jpeg: bool = False) -> None:
        with self._lock:
            self._counts[path] = self._counts.get(path, 0) + n
            if path == "pil" and jpeg:
                self._counts["pil_jpeg"] += n

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


def pil_decode(source, transform, index: int) -> np.ndarray:
    """One image (a path or bytes) through PIL and `transform`."""
    from PIL import Image
    with Image.open(io.BytesIO(source) if isinstance(source, bytes) else source) as img:
        img = img.convert("RGB")
    if transform is not None:
        return transform(img, index=index)
    return np.asarray(img, np.float32) / 255.0


def resolve_native(use_native: Optional[bool], transform) -> bool:
    """The decode path a dataset takes: None means native where the library
    builds; True without the library raises."""
    if transform is None or not hasattr(transform, "native_params"):
        return False
    if use_native is None:
        return native.available()
    if use_native and not native.available():
        from vitax_torch import _native
        raise RuntimeError(f"use_native=True but the native data path is unavailable: "
                           f"{_native.unavailable_reason()}")
    return bool(use_native)


class ImageFolderDataset:
    def __init__(self, root: str, transform: Optional[Callable] = None, use_native: Optional[bool] = None):
        self.root = root
        self.transform = transform
        self.classes, self.samples = list_imagefolder(root)
        self.use_native = resolve_native(use_native, transform)
        self._normalize = getattr(transform, "normalize", True)
        self.decoded = DecodeCounts()

    def set_epoch(self, epoch: int) -> None:
        if self.transform is not None and hasattr(self.transform, "set_epoch"):
            self.transform.set_epoch(epoch)

    def _shape_args(self) -> Tuple[int, int]:
        """(out_size, resize_to) for the native calls."""
        return self.transform.image_size, getattr(self.transform, "resize_to", 0)

    def _native_params(self, idx: int) -> Optional[Tuple[int, ...]]:
        """The native decoder's params for item idx, or None for PIL."""
        path = self.samples[idx][0]
        if not self.use_native or not native.is_jpeg_path(path):
            return None
        size = native.jpeg_size(path)
        return None if size is None else self.transform.native_params(size[0], size[1], idx)

    def _pil_item(self, idx: int) -> Tuple[np.ndarray, int]:
        path, label = self.samples[idx]
        img = pil_decode(path, self.transform, idx)
        self.decoded.add("pil", jpeg=native.is_jpeg_path(path))
        return img, label

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        params = self._native_params(idx)
        if params is not None:
            out_size, resize_to = self._shape_args()
            arr = native.process_file(self.samples[idx][0], params, out_size, resize_to,
                                      normalize=self._normalize)
            if arr is not None:
                self.decoded.add("native")
                return arr, self.samples[idx][1]
        return self._pil_item(idx)

    def load_batch(self, indices: Sequence[int], n_threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
        """A whole batch: one GIL-free C++ call decodes and transforms every
        JPEG on a thread pool; other or failed items go through PIL, on
        `n_threads` threads. Returns (images (N, S, S, 3), labels (N,)
        int32): uint8, or float32 normalized when the transform normalizes."""
        indices = [int(i) for i in indices]
        labels = np.asarray([self.samples[i][1] for i in indices], np.int32)
        out_size, resize_to = self._shape_args()
        images = np.empty((len(indices), out_size, out_size, 3), np.float32 if self._normalize else np.uint8)
        native_pos, params = [], []
        for pos, i in enumerate(indices):
            p = self._native_params(i)
            if p is not None:
                native_pos.append(pos)
                params.append(p)
        fallback = sorted(set(range(len(indices))) - set(native_pos))
        if native_pos:
            batch, failed = native.process_batch([self.samples[indices[p]][0] for p in native_pos], params,
                                                 out_size, resize_to, n_threads, normalize=self._normalize)
            failed = set(failed)
            for j, pos in enumerate(native_pos):
                if j in failed:
                    fallback.append(pos)
                else:
                    images[pos] = batch[j]
            self.decoded.add("native", len(native_pos) - len(failed))
        # PIL releases the GIL while it decodes and resamples, so threads help
        with ThreadPoolExecutor(max(1, min(n_threads, len(fallback)))) as pool:
            for pos, (img, _) in zip(fallback, pool.map(reporting(self._pil_item), [indices[p] for p in fallback])):
                images[pos] = img
        return images, labels

    def __len__(self) -> int:
        return len(self.samples)

    def __repr__(self) -> str:
        path = "native" if self.use_native else "PIL"
        return (f"ImageFolderDataset(root={self.root!r}, classes={len(self.classes)}, "
                f"samples={len(self.samples)}, decode={path})")
