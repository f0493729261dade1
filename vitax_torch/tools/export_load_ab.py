"""How a serving replica's quantized export reaches the card, each way in turns.

    python -m vitax_torch.tools.export_load_ab [--dir /dev/shm] [--rounds 2]

Exports the seeded full 10B model int8 (checkpoint/consolidate.py
save_npz_from_state, block by block on the card; about 10.1 GB) into
--dir, then loads it onto the card the ways a replica can, each timed to a
synchronized end, in turns for --rounds rounds:
  zip read + host layout  load_npz_raw (np.load) then params_from_jax on
                          the host, then each leaf to the card (pageable)
  mapped + pageable       load_npz_raw(mapped=True), each leaf to the card
                          with a pageable copy, laid out there
  mapped + staged         load_npz_raw(mapped=True) and serve/engine.py
                          npz_state (PinnedStager), the engine's path
Each way's state is checked bit for bit against the first's. Prints a line
a way and round with the card's name and power limit. Needs a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import torch

from vitax_torch.checkpoint.consolidate import load_npz_raw, save_npz_from_state
from vitax_torch.checkpoint.convert import params_from_jax
from vitax_torch.config import Config
from vitax_torch.models.vit import build_model
from vitax_torch.serve.engine import npz_state


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def zip_host(path: str, dev: torch.device) -> dict:
    flat, scales, _ = load_npz_raw(path)
    return {k: v.to(dev) for k, v in params_from_jax(flat, scales).items()}


def mapped_pageable(path: str, dev: torch.device) -> dict:
    flat, scales, _ = load_npz_raw(path, mapped=True)
    state = {}
    for key in list(flat):
        scale = {key: scales.pop(key).to(dev, copy=True)} if key in scales else None
        state.update(params_from_jax({key: flat.pop(key).to(dev, copy=True)}, scale))
    return state


def mapped_staged(path: str, dev: torch.device) -> dict:
    flat, scales, _ = load_npz_raw(path, mapped=True)
    return npz_state(flat, scales, dev)


WAYS = (("zip read + host layout", zip_host), ("mapped + pageable", mapped_pageable),
        ("mapped + staged", mapped_staged))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dir", default="/dev/shm" if os.path.isdir("/dev/shm") else None)
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("export_load_ab: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    label = card()
    work = tempfile.mkdtemp(prefix="vitax_torch_export_ab_", dir=args.dir)
    path = os.path.join(work, "int8.npz")
    try:
        model = build_model(Config(seed=0, serve_port=0).validate(), dev)
        t0 = time.perf_counter()
        save_npz_from_state(path, model.state_dict(), "int8")
        print(f"export: {os.path.getsize(path) / 1e9:.2f} GB in {time.perf_counter() - t0:.1f}s [{label}]",
              flush=True)
        del model
        torch.cuda.empty_cache()
        want = None
        for r in range(args.rounds):
            for name, fn in (WAYS if r % 2 == 0 else WAYS[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state = fn(path, dev)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                if want is None:
                    want = {k: v.clone() for k, v in state.items()}
                same = set(state) == set(want) and all(torch.equal(state[k], want[k]) for k in want)
                print(f"round {r + 1}, {name}: {dt:.2f}s ({os.path.getsize(path) / 1e9 / dt:.2f} GB/s), state bit for "
                      f"bit the first way's: {same} [{label}]", flush=True)
                del state
                torch.cuda.empty_cache()
                if not same:
                    return 1
    finally:
        if os.path.exists(path):
            os.remove(path)
        os.rmdir(work)
    return 0


if __name__ == "__main__":
    sys.exit(main())
