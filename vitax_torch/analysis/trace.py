"""Evidence of one eager call: what the program rules read.

Stands where vitax/analysis/hlo.py stood. vitax's rules parse the lowered
program (StableHLO, the partitioned HLO, the traced jaxpr); the port's step
is eager, so its evidence is what one call of it does, taken while it runs:

- `OpRecorder`, a TorchDispatchMode: every aten op of the call with its
  input and output dtypes, shapes, devices and bytes (each input read once,
  each output written once). From the rows it finds host syncs
  (`aten._local_scalar_dense`, an op that takes a device tensor and gives a
  CPU one, `aten.nonzero`, and a blocking copy from the host to the card,
  which waits for the stream), float tensors made from int8, uint8 or float8
  tensors of a weight's shape, and parameter-sized float temporaries of the
  optimizer's ops. The kernels are ctypes calls, not aten ops: the recorder
  never sees a launch (`launch_delta` does, on the card). Ops inside a
  dispatcher's call (ops/_build.py `dispatch`: fused_clip_adamw,
  dequant_matmul) carry that kernel's name as their `region`, so the plain
  versions the CPU runs are told apart from the rest of the step. The mode
  sits above DTensor: a sharded op is one row, at the DTensor's global
  shape. It is carried onto the autograd engine's threads, so the backward
  and the blocks' recompute under torch.utils.checkpoint are recorded too.
- `storage_map`: each param, mu, nu and the step count of a train state by
  (storage data_ptr, nbytes), local shards of DTensors.
- `launch_delta`: ops/_build.py's LAUNCHES and CALLS, and builds(), before
  and after a call.
- `collectives` and `fsdp_ranges`: a torch.profiler Chrome trace taken with
  record_shapes=True around a step marked by a `vitax_step_<n>` range (the
  range of telemetry/profiler.py's window, read through its
  `trace_events`). gloo records no `record_param_comms` events, on the CPU
  or on the card, so each collective is read from its c10d op
  (`c10d::_allgather_base_`, `c10d::_reduce_scatter_base_`,
  `c10d::allreduce_`), a dispatcher op whatever the backend, with its
  recorded input types and dims: name, dtype, element count, and issue
  order from the timestamps. FSDP2's own ranges (`FSDP::all_gather
  (<module>)`, `FSDP::post_forward (<module>)`) give each unit's gather
  and the end of its forward.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from vitax_torch.ops import _build
from vitax_torch.telemetry.profiler import STEP_PREFIX, trace_events

# ops that make the host wait for the card: a scalar read, and an op whose
# output size depends on the data
SYNC_OPS = ("aten._local_scalar_dense", "aten.nonzero")
# the optimizer's tell-tales at parameter size (torch.optim.AdamW's foreach
# chain, an unfused clip): outside the kernel they mean the update fell back
# to a tree of ops
OPTIMIZER_OPS = ("sqrt", "where", "addcdiv", "lerp")
QUANT_DTYPES = (torch.int8, torch.uint8, torch.float8_e4m3fn)
_SHORT_DTYPE = {"c10::BFloat16": "bf16", "float": "f32", "c10::Half": "f16", "double": "f64"}
_COLLECTIVE_OPS = {"c10d::_allgather_base_": "all-gather", "c10d::allgather_into_tensor_coalesced_": "all-gather",
                   "c10d::_reduce_scatter_base_": "reduce-scatter",
                   "c10d::reduce_scatter_tensor_coalesced_": "reduce-scatter", "c10d::allreduce_": "all-reduce"}
_FSDP_RANGE_RE = re.compile(r"^FSDP::(all_gather|pre_forward|post_forward) \((.+)\)$")


@dataclasses.dataclass
class OpRow:
    """One aten op of a recorded call."""
    op: str                                 # the overload packet, e.g. "aten.mm"
    in_dtypes: Tuple[torch.dtype, ...]
    in_shapes: Tuple[Tuple[int, ...], ...]
    in_devices: Tuple[str, ...]             # device types
    out_dtypes: Tuple[torch.dtype, ...]
    out_shapes: Tuple[Tuple[int, ...], ...]
    out_devices: Tuple[str, ...]
    bytes: int                              # inputs read once + outputs written once
    region: str = ""                        # the dispatcher call it ran inside ("" = none)
    sync: bool = False                      # the host waits for the card here

    def to_json(self) -> dict:
        return {"op": self.op, "in": [f"{str(d).replace('torch.', '')}{list(s)}@{v}"
                                      for d, s, v in zip(self.in_dtypes, self.in_shapes, self.in_devices)],
                "out": [f"{str(d).replace('torch.', '')}{list(s)}@{v}"
                        for d, s, v in zip(self.out_dtypes, self.out_shapes, self.out_devices)],
                "bytes": self.bytes, "region": self.region, "sync": self.sync}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _syncs(op: str, args, kwargs, ins: List[torch.Tensor], outs: List[torch.Tensor]) -> bool:
    """Does this op make the host wait for the card: a scalar read, a
    data-dependent size, a device tensor copied to the host, or a blocking
    copy from the host to the card (PyTorch synchronizes the stream after a
    copy that is not non_blocking)?"""
    if op in SYNC_OPS:
        return True
    if any(t.device.type != "cpu" for t in ins) and any(t.device.type == "cpu" for t in outs):
        return True
    if op not in ("aten._to_copy", "aten.copy_") or not outs or outs[0].device.type == "cpu":
        return False
    src = args[1] if op == "aten.copy_" else args[0]
    non_blocking = (args[2] if op == "aten.copy_" and len(args) > 2 else kwargs.get("non_blocking", False))
    return isinstance(src, torch.Tensor) and src.device.type == "cpu" and not non_blocking


class OpRecorder(TorchDispatchMode):
    """Record every aten op of the calls made under it (`rows`). Recording
    reads only metadata (dtype, shape, device), never a value: the call
    computes what it computes unrecorded, and syncs nowhere it did not."""

    def __init__(self):
        super().__init__()
        self.rows: List[OpRow] = []
        self._regions: List[str] = []

    def __enter__(self):
        _build.WATCHERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _build.WATCHERS.remove(self)

    # ops/_build.py dispatch() calls these around a dispatcher's body
    def enter(self, name: str) -> None:
        self._regions.append(name)

    def exit(self, name: str) -> None:
        self._regions.pop()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        op = str(func.overloadpacket) if hasattr(func, "overloadpacket") else str(func)
        self.rows.append(OpRow(
            op=op,
            in_dtypes=tuple(t.dtype for t in ins), in_shapes=tuple(tuple(t.shape) for t in ins),
            in_devices=tuple(t.device.type for t in ins),
            out_dtypes=tuple(t.dtype for t in outs), out_shapes=tuple(tuple(t.shape) for t in outs),
            out_devices=tuple(t.device.type for t in outs),
            bytes=sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs),
            region=self._regions[-1] if self._regions else "", sync=_syncs(op, args, kwargs, ins, outs)))
        return out

    # -- what the rules ask of the rows ---------------------------------------

    def host_syncs(self) -> List[OpRow]:
        """Rows that make the host wait for the card (`_syncs`)."""
        return [r for r in self.rows if r.sync]

    def quant_casts(self, weight_shapes: Iterable[Tuple[int, ...]], min_elems: int,
                    exempt: Iterable[Tuple[int, ...]] = ()) -> List[OpRow]:
        """Rows outside every dispatcher call that make a float tensor of a
        weight's shape (or its transpose), at least `min_elems` elements,
        from an int8, uint8 or float8 input of as many elements: a
        dequantized weight round-tripping through memory."""
        shapes = _with_transposes(weight_shapes) - set(tuple(s) for s in exempt)
        rows = []
        for r in self.rows:
            if r.region:
                continue
            quant_numels = {_numel(s) for d, s in zip(r.in_dtypes, r.in_shapes) if d in QUANT_DTYPES}
            for d, s in zip(r.out_dtypes, r.out_shapes):
                if (d.is_floating_point and tuple(s) in shapes and _numel(s) >= min_elems
                        and _numel(s) in quant_numels):
                    rows.append(r)
                    break
        return rows

    def param_sized(self, param_shapes: Iterable[Tuple[int, ...]], min_elems: int,
                    ops: Sequence[str] = OPTIMIZER_OPS) -> List[OpRow]:
        """Rows outside every dispatcher call of the `ops` (any aten.<op>,
        in place or not, and its _foreach_ form) with a float output of a
        parameter's shape and at least `min_elems` elements."""
        shapes = set(tuple(s) for s in param_shapes)
        names = set()
        for op in ops:
            names |= {f"aten.{op}", f"aten.{op}_", f"aten._foreach_{op}", f"aten._foreach_{op}_"}
        rows = []
        for r in self.rows:
            if r.region or r.op not in names:
                continue
            if any(d.is_floating_point and tuple(s) in shapes and _numel(s) >= min_elems
                   for d, s in zip(r.out_dtypes, r.out_shapes)):
                rows.append(r)
        return rows

    def count(self, op: str) -> int:
        return sum(1 for r in self.rows if r.op == op)


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _with_transposes(shapes: Iterable[Tuple[int, ...]]) -> Set[Tuple[int, ...]]:
    out = set()
    for s in shapes:
        s = tuple(s)
        out.add(s)
        if len(s) == 2:
            out.add((s[1], s[0]))
    return out


# -- storages of a train state -------------------------------------------------

def storage_map(state) -> Dict[str, Tuple[int, int]]:
    """{"param/<name>", "mu/<name>", "nu/<name>", "count"} -> (storage
    data_ptr, storage nbytes) of a train state (train/state.py), the local
    shards of DTensors."""
    from vitax_torch.train.state import local

    def entry(t: torch.Tensor) -> Tuple[int, int]:
        st = local(t).untyped_storage()
        return st.data_ptr(), st.nbytes()

    out = {f"param/{n}": entry(p) for n, p in state.model.named_parameters()}
    out.update({f"mu/{n}": entry(v) for n, v in state.mu.items()})
    out.update({f"nu/{n}": entry(v) for n, v in state.nu.items()})
    out["count"] = entry(state.count)
    return out


def local_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of the rank's part of `t` (a DTensor's local shard)."""
    from vitax_torch.train.state import local
    return local(t).detach().clone()


def state_leaves(state) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every param, mu and nu of a train state, as held
    (DTensors stay DTensors)."""
    out = [(f"param/{n}", p) for n, p in state.model.named_parameters()]
    out += [(f"mu/{n}", v) for n, v in state.mu.items()]
    out += [(f"nu/{n}", v) for n, v in state.nu.items()]
    return out


# -- kernel launches -------------------------------------------------------------

@dataclasses.dataclass
class Launches:
    """LAUNCHES, CALLS and builds() deltas of one call (filled on exit)."""
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    builds: int = 0


@contextlib.contextmanager
def launch_delta() -> Iterator[Launches]:
    """Launch, dispatcher-call and build counts made inside the block, by
    name (nonzero entries only)."""
    l0, c0, b0 = dict(_build.LAUNCHES), dict(_build.CALLS), _build.builds()
    out = Launches()
    try:
        yield out
    finally:
        out.launches = {k: v - l0.get(k, 0) for k, v in _build.LAUNCHES.items() if v != l0.get(k, 0)}
        out.calls = {k: v - c0.get(k, 0) for k, v in _build.CALLS.items() if v != c0.get(k, 0)}
        out.builds = _build.builds() - b0


# -- collectives from a profiler trace --------------------------------------------

def _window(events: List[dict]) -> Tuple[float, float]:
    """[start, end] in microseconds of the trace's vitax_step_ ranges."""
    ranges = [e for e in events
              if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(STEP_PREFIX)]
    if not ranges:
        return float("-inf"), float("inf")
    return (min(float(e["ts"]) for e in ranges),
            max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in ranges))


def _dims_numel(dims) -> int:
    return _numel(dims) if isinstance(dims, list) and all(isinstance(d, int) for d in dims) else 0


def collectives(path: str) -> List[dict]:
    """The collectives issued inside the trace's step range, in issue
    order: {"op" all-gather | reduce-scatter | all-reduce, "dtype" (bf16,
    f32, ...), "numel" (the unsharded buffer: the gather's output, the
    reduce-scatter's input), "ts" (microseconds)}."""
    events = trace_events(path)
    t0, t1 = _window(events)
    rows = []
    for e in events:
        op = _COLLECTIVE_OPS.get(e.get("name", ""))
        ts = float(e.get("ts", 0.0))
        if op is None or e.get("ph") != "X" or not t0 <= ts <= t1:
            continue
        args = e.get("args", {})
        types, dims = args.get("Input type", []), args.get("Input Dims", [])
        dtype = _SHORT_DTYPE.get(types[0], types[0]) if types else ""
        if op == "all-reduce":          # a TensorList: the first tensor
            first = dims[0][0] if dims and dims[0] and isinstance(dims[0][0], list) else []
            numel = _dims_numel(first)
            dtype = ""
        else:
            numel = max((_dims_numel(d) for d in dims[:2]), default=0)
        rows.append({"op": op, "dtype": dtype, "numel": numel, "ts": ts})
    rows.sort(key=lambda r: r["ts"])
    return rows


def fsdp_ranges(path: str) -> List[dict]:
    """FSDP2's ranges inside the trace's step range, in order: {"kind"
    all_gather | pre_forward | post_forward, "module" (its fqn), "ts"}."""
    events = trace_events(path)
    t0, t1 = _window(events)
    rows = []
    for e in events:
        m = _FSDP_RANGE_RE.match(str(e.get("name", "")))
        ts = float(e.get("ts", 0.0))
        if m and e.get("ph") == "X" and t0 <= ts <= t1:
            rows.append({"kind": m.group(1), "module": m.group(2), "ts": ts})
    rows.sort(key=lambda r: r["ts"])
    return rows


def forward_gather_order(ranges: List[dict], blocks: int) -> Dict[str, Optional[float]]:
    """For each block k: the first `FSDP::all_gather (blocks.k)` and the
    first `FSDP::post_forward (blocks.k)` timestamps of the step (the
    forward's; a recompute's come later), as {"gather_k", "end_k"}."""
    out: Dict[str, Optional[float]] = {}
    for k in range(blocks):
        name = f"blocks.{k}"
        out[f"gather_{k}"] = next((r["ts"] for r in ranges if r["module"] == name and r["kind"] == "all_gather"),
                                  None)
        out[f"end_{k}"] = next((r["ts"] for r in ranges if r["module"] == name and r["kind"] == "post_forward"),
                               None)
    return out
