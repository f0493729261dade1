"""Peer-replicated state shards (vitax/checkpoint/peer.py; --replicate_steps,
--peer_dir).

Every `--replicate_steps` window, each process packs its staged state
shard (checkpoint/snapshot.py HostSnapshot) into one checksummed blob,
versioned by (epoch, step_in_epoch, topology), spills it to its own local
peer store and mirrors it to its ring buddy: process i sends to
(i + 1) % N and so guards (i - 1) % N. The bytes go over c10d stores in
chunks of CHUNK_BYTES: each process serves a TCPStore of its own (its
address published in the process group's store) into which its guard
writes, so a replica waits in its buddy's memory even when the sender
dies at once, and the group's store, which carries the heartbeats
(train/control.py), never queues them behind gigabytes. The previous
generation's chunks are deleted before the next one goes up, and the
receiver deletes what it has spilled. After a lost process, the
relaunched group negotiates a restore from the survivors' stores: no
checkpoint is read from the checkpoint directory (io.restore_read_count
stays where it was).

The store's keys die with the group (a relaunch makes a new store), so the
replicas live on the processes' disks: PeerStore under --peer_dir
(default <ckpt_dir>/peerstore, VITAX_PEER_DIR overrides), one
subdirectory p<rank> a process, so deleting p<rank> is a lost host.

negotiate_restore: every process publishes what its store holds, process
0 picks the newest version whose shards cover the whole topology and are
at least as fresh as the DCP frontier, every process checksum-verifies
every copy it holds and publishes the shards it needs and lacks (or holds
corrupt), their holders serve those from their own stores (the ones
replication writes into) a window of chunks at a time, the fetcher
deleting each chunk it has spilled, and
a BIT_PEER_RESTORE agreement (train/control.py agree_peer_restore) lets
one process veto the peer path for all. The fold runs again after the
load itself (restore_state_preferring_peers), so a failure there also
sends every process to the DCP checkpoint together.

Every blob carries a crc32; PeerStore.load checks it (and fires the
`peer_restore` fault site) and raises PeerRestoreError on a mismatch.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from vitax_torch import faults
from vitax_torch.telemetry.threads import join_or_warn
from vitax_torch.utils.logging import master_print

# bytes a store value carries: the TCPStore's server takes at most 8 MiB a
# message, and 2 MiB moved the most a second (a 10B FSDP shard is gigabytes)
CHUNK_BYTES = 1 << 21

PEER_KEY_PREFIX = "vitax/peer"          # replication transport
PEER_ADDR_PREFIX = "vitax/peer_addr"    # where each process's own store listens
RESTORE_KEY_PREFIX = "vitax/restore"    # negotiation and shard serving
# a negotiation's bound on a wait that moves no bulk (vitax's KV deadline),
# and on each served chunk: a 2 MiB chunk moves in milliseconds
KV_TIMEOUT_S = 30.0
# the want lists wait for every process's verification of what it holds, so
# that wait grows with the bytes held: the card machine read and checked
# 3.89 GB in under 4.24 s (chip_smoke.py phase 7e (e)); a tenth of that rate
VERIFY_FLOOR_BYTES_S = 100e6
SERVE_WINDOW = 32                       # chunks a served shard may have waiting in its holder's store


class PeerRestoreError(RuntimeError):
    """A peer shard is missing, incomplete, or failed its checksum."""


def ring_buddy(process_index: int, process_count: int) -> int:
    """The process that receives this process's replica: (i + 1) % N."""
    return (process_index + 1) % process_count


def ring_guard(process_index: int, process_count: int) -> int:
    """The process whose replica this process stores: (i - 1) % N."""
    return (process_index - 1) % process_count


def default_peer_root(ckpt_dir: str) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), "peerstore")


def resolve_peer_dir(cfg, process_index: Optional[int] = None) -> str:
    """This process's peer store: VITAX_PEER_DIR > --peer_dir >
    <ckpt_dir>/peerstore, with p<rank> appended."""
    root = os.environ.get("VITAX_PEER_DIR", "") or getattr(cfg, "peer_dir", "") or default_peer_root(cfg.ckpt_dir)
    if process_index is None:
        from vitax_torch.distributed import process_index as rank
        process_index = rank()
    return os.path.join(root, f"p{process_index}")


def progress_key(epoch: int, step_in_epoch: int) -> Tuple[int, int]:
    """Comparable progress: a boundary save of epoch e (step 0) means e is
    complete, so it counts as (e + 1, 0) and beats any (e, s)."""
    epoch, step = int(epoch), int(step_in_epoch)
    return (epoch + 1, 0) if step == 0 else (epoch, step)


# -- pack / unpack -------------------------------------------------------------


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def pack_snapshot(snapshot, src: int) -> Tuple[dict, List[memoryview]]:
    """HostSnapshot -> (meta, payload). The payload is the raw bytes of the
    process's shards one after another, as views of the staged buffers (no
    copy: a 10B shard is gigabytes); the meta holds the version, each
    leaf's global shape, dtype and shard box with its byte range (so a
    restore can place it), the resume fields the elastic planner reads
    (the meta doubles as a sidecar) and the payload's crc32."""
    leaves, parts, crc, offset = [], [], 0, 0
    for i, spec in enumerate(snapshot.specs):
        if spec.index is None:
            raise ValueError(f"peer replication: leaf {spec.path!r} is a strided shard (tp); its rank's part is "
                             f"no box of the global tensor, so it cannot be replicated")
        buf = snapshot.buffers(i)
        n = buf.numel() * buf.element_size()
        if n:
            view = memoryview(buf.reshape(-1).view(torch.uint8).numpy())
            parts.append(view)
            crc = zlib.crc32(view, crc)
        leaves.append({"path": spec.path, "shape": list(spec.shape), "dtype": _dtype_name(spec.dtype),
                       "shards": [{"index": [list(ab) for ab in spec.index], "offset": offset, "nbytes": n}]})
        offset += n
    meta = {"version": list(snapshot.version), "src": int(src), "step_in_epoch": snapshot.step_in_epoch,
            "process_count": snapshot.process_count, "leaves": leaves, "crc32": crc & 0xFFFFFFFF, "nbytes": offset}
    if snapshot.stream_cursor is not None:
        meta["stream_cursor"] = snapshot.stream_cursor
    return meta, parts


def _parts(payload) -> list:
    """A payload as a list of byte buffers (pack_snapshot's views, or one
    bytes-like object)."""
    return payload if isinstance(payload, list) else [payload]


def _chunks(payload, size: int):
    """The payload's bytes in pieces of `size` (the last one shorter)."""
    pending, have, sent = [], 0, False
    for part in _parts(payload):
        view = memoryview(part).cast("B")
        while len(view):
            take = view[:size - have]
            pending.append(take)
            have += len(take)
            view = view[len(take):]
            if have == size:
                yield b"".join(pending)
                pending, have, sent = [], 0, True
    if pending or not sent:             # an empty payload is one empty chunk
        yield b"".join(pending)


def unpack_payload(meta: dict, payload) -> Dict[str, List[Tuple[Tuple[Tuple[int, int], ...], torch.Tensor]]]:
    """{path: [(box, tensor over the payload's bytes)]} of one blob."""
    out: Dict[str, list] = {}
    for leaf in meta["leaves"]:
        dtype = getattr(torch, leaf["dtype"])
        for sh in leaf["shards"]:
            box = tuple((int(a), int(b)) for a, b in sh["index"])
            shape = [b - a for a, b in box]
            numel = 1
            for d in shape:
                numel *= d
            t = (torch.frombuffer(payload, dtype=dtype, count=numel, offset=int(sh["offset"])) if numel
                 else torch.empty(0, dtype=dtype))
            out.setdefault(leaf["path"], []).append((box, t.reshape(shape)))
    return out


# -- the local store -----------------------------------------------------------


class PeerStore:
    """<root>/host_<src>/{meta.json, shard.bin}: the replicas this process
    holds, its own shard and its guard's. The payload is written first and
    the meta renamed in after it, so a meta.json always describes a whole
    payload."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    def _dir(self, src: int) -> str:
        return os.path.join(self.root, f"host_{int(src)}")

    def put(self, meta: dict, payload) -> None:
        self.put_stream(meta, _parts(payload), verify=False)

    def put_stream(self, meta: dict, chunks, verify: bool = True) -> None:
        """Write a replica from an iterable of byte chunks, then its meta;
        with `verify`, PeerRestoreError (and nothing kept) when the bytes
        fail the meta's crc32."""
        d = self._dir(meta["src"])
        os.makedirs(d, exist_ok=True)
        blob = os.path.join(d, "shard.bin")
        tmp = blob + f".tmp{os.getpid()}"
        crc = 0
        with open(tmp, "wb") as f:
            for chunk in chunks:
                f.write(chunk)
                if verify:
                    crc = zlib.crc32(chunk, crc)
        if verify and (crc & 0xFFFFFFFF) != int(meta.get("crc32", -1)):
            os.remove(tmp)
            raise PeerRestoreError(f"peer transport: the replica of host {meta['src']} failed its checksum after "
                                   f"reassembly")
        os.replace(tmp, blob)
        mpath = os.path.join(d, "meta.json")
        tmp = mpath + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(json.dumps(meta))
        os.replace(tmp, mpath)

    def holdings(self) -> Dict[int, dict]:
        """{src: meta} of every readable replica; an unreadable one is a
        missing one."""
        out: Dict[int, dict] = {}
        if not os.path.isdir(self.root):
            return out
        for name in sorted(os.listdir(self.root)):
            if not name.startswith("host_"):
                continue
            try:
                with open(os.path.join(self.root, name, "meta.json")) as f:
                    meta = json.load(f)
                out[int(meta["src"])] = meta
            except (OSError, ValueError, KeyError):
                continue
        return out

    def load(self, src: int, expect_version: Optional[Tuple[int, int, int]] = None) -> Tuple[dict, bytearray]:
        """Read and verify one replica; PeerRestoreError on a missing file,
        a version mismatch or a checksum failure. The `peer_restore` fault
        site fires once a load."""
        d = self._dir(src)
        try:
            faults.fire("peer_restore", index=int(src))
            with open(os.path.join(d, "meta.json")) as f:
                meta = json.load(f)
            path = os.path.join(d, "shard.bin")
            payload = bytearray(os.path.getsize(path))
            with open(path, "rb") as f:
                if f.readinto(payload) != len(payload):
                    raise OSError(f"short read of {path}")
        except (OSError, ValueError) as e:
            raise PeerRestoreError(f"peer shard for host {src} unreadable at {d}: {type(e).__name__}: {e}") from e
        if expect_version is not None and tuple(meta.get("version", ())) != tuple(expect_version):
            raise PeerRestoreError(f"peer shard for host {src} is version {meta.get('version')}, wanted "
                                   f"{list(expect_version)}")
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        if crc != int(meta.get("crc32", -1)):
            raise PeerRestoreError(f"peer shard for host {src} FAILED its checksum (crc32 {crc:#x} != recorded "
                                   f"{int(meta.get('crc32', 0)):#x}) — replica at {d} is corrupt")
        return meta, payload


    def chunks(self, src: int, size: int):
        """A held replica's payload in pieces of `size`, read from disk (the
        caller verified it; the fetcher checks the crc32 again)."""
        with open(os.path.join(self._dir(src), "shard.bin"), "rb") as f:
            while True:
                chunk = f.read(size)
                if not chunk:
                    return
                yield chunk


def store_frontier(root: str) -> Tuple[int, int]:
    """The normalized (progress_key) frontier over every per-process store
    under `root`; (0, 0) when empty. The supervisor folds it into its
    crash-loop progress (supervise.py run_progress)."""
    best = (0, 0)
    if not os.path.isdir(root):
        return best
    for sub in sorted(os.listdir(root)):
        d = os.path.join(root, sub)
        if not (sub.startswith("p") and os.path.isdir(d)):
            continue
        for meta in PeerStore(d).holdings().values():
            v = meta.get("version") or [0, 0, 0]
            if int(v[0]) or int(v[1]):
                best = max(best, progress_key(v[0], v[1]))
    return best


# -- the store transport -------------------------------------------------------


def _publish_blob(client, prefix: str, meta: dict, payload, gen: int) -> int:
    """Chunks first, the meta (the receiver's trigger) last, so a reader
    never sees a meta whose chunks are missing; `gen` versions the chunk
    keys, so a reader of gen k never mixes in gen k + 1. Returns the chunk
    count."""
    n = 0
    for i, chunk in enumerate(_chunks(payload, CHUNK_BYTES)):
        client.key_value_set(f"{prefix}/g{gen}/c{i}", chunk)
        n = i + 1
    client.key_value_set(f"{prefix}/meta", json.dumps(dict(meta, gen=int(gen), n_chunks=n)))
    return n


def _fetch_meta(client, prefix: str, timeout_ms: int, min_gen: int = 0) -> Optional[dict]:
    """The newest publication's meta under `prefix`, or None (none yet, or
    none newer than `min_gen`)."""
    try:
        meta = json.loads(client.blocking_key_value_get(f"{prefix}/meta", timeout_ms))
    except Exception:  # noqa: BLE001 - no publication yet is the common case
        return None
    return meta if int(meta.get("gen", 0)) > min_gen else None


def _fetch_chunks(client, prefix: str, meta: dict, timeout_ms: int):
    """The publication's chunks in order; PeerRestoreError when one is gone
    (a newer publication replaced it)."""
    gen = int(meta.get("gen", 0))
    for i in range(int(meta["n_chunks"])):
        try:
            yield client.blocking_key_value_get_bytes(f"{prefix}/g{gen}/c{i}", timeout_ms)
        except Exception as e:  # noqa: BLE001 - a vanished chunk is a failed fetch, not a crash
            raise PeerRestoreError(f"peer transport: chunk fetch under {prefix} gen {gen} failed "
                                   f"({type(e).__name__}: {e})") from e


def _receive_into(store: PeerStore, client, prefix: str, timeout_ms: int, min_gen: int = 0) -> Optional[dict]:
    """The newest publication under `prefix` streamed into `store` (never
    whole in memory); its meta, or None when there is nothing newer."""
    meta = _fetch_meta(client, prefix, timeout_ms, min_gen)
    if meta is None:
        return None
    store.put_stream(meta, _fetch_chunks(client, prefix, meta, timeout_ms))
    return meta


# -- replication ---------------------------------------------------------------


def _store_host() -> str:
    """The address a buddy reaches this process's store at: MASTER_ADDR
    when it is this host's loopback (one host), else this host's name."""
    import socket
    master = os.environ.get("MASTER_ADDR", "")
    return master if master in ("127.0.0.1", "localhost", "::1") else socket.getfqdn()


class PeerReplicator:
    """One process's replication duties: the self-spill and the publication
    into its buddy's store (replicate(), on the snapshot pipeline's
    worker), and its own store with a receiver thread that spills the
    guard's publications. Alone it spills only: the store still feeds a
    one-process peer restore and the supervisor's frontier. `client` is
    the group's store (StoreKV) that carries the stores' addresses."""

    def __init__(self, store: PeerStore, process_index: int, process_count: int, client=None, on_event=None,
                 poll_s: Optional[float] = None):
        self.store = store
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.client = client
        self.on_event = on_event
        self.poll_s = float(poll_s) if poll_s is not None else float(os.environ.get("VITAX_PEER_POLL_S", 2.0))
        self.buddy = ring_buddy(self.process_index, self.process_count)
        self.guard = ring_guard(self.process_index, self.process_count)
        self._gen = 0
        self._chunks = 0                # of the previous generation, deleted before the next goes up
        self._received = 0              # the guard's newest generation in the local store
        self._inbox = None              # this process's own store, which the guard writes into
        self._clients: Dict[int, object] = {}   # other processes' stores: the buddy's, a restore's holders'
        self._stop = threading.Event()
        self._receiver: Optional[threading.Thread] = None

    def store_of(self, pid: int):
        """The store process `pid` serves: this process's own, or a client of
        another's, its address read (bounded) from the group's store. The
        buddy's carries the replicas; any holder's serves a restore."""
        if pid == self.process_index:
            return self._inbox
        if pid not in self._clients:
            import datetime
            import torch.distributed as dist
            from vitax_torch.train.control import StoreKV
            addr = self.client.blocking_key_value_get(f"{PEER_ADDR_PREFIX}/{pid}", 60_000)
            host, port = addr.rsplit(":", 1)
            self._clients[pid] = StoreKV(dist.TCPStore(host, int(port), None, False,
                                                       timeout=datetime.timedelta(seconds=60)))
        return self._clients[pid]

    def replicate(self, snapshot) -> None:
        """Pack, spill and publish one staged snapshot, on the pipeline's
        worker: none of it holds a step."""
        t0 = time.perf_counter()
        meta, payload = pack_snapshot(snapshot, src=self.process_index)
        self.store.put(meta, payload)
        if self.process_count > 1 and self.client is not None:
            outbox, prefix = self.store_of(self.buddy), f"{PEER_KEY_PREFIX}/{self.process_index}"
            # the previous generation goes first: the buddy's store holds one
            # copy (its disk keeps its last whole one meanwhile)
            for i in range(self._chunks):
                outbox.key_value_delete(f"{prefix}/g{self._gen}/c{i}")
            self._gen += 1
            self._chunks = _publish_blob(outbox, prefix, meta, payload, self._gen)
        self._emit("peer_replication", bytes=meta["nbytes"], version=list(snapshot.version), src=self.process_index,
                   buddy=self.buddy, seconds=round(time.perf_counter() - t0, 6))

    def start_receiver(self) -> bool:
        """Serve this process's store (its address in the group's store) and
        spill the guard's publications from it. False alone or without the
        group's store."""
        if self.process_count <= 1 or self.client is None:
            return False
        import datetime
        import torch.distributed as dist
        from vitax_torch.train.control import StoreKV
        host = _store_host()
        server = dist.TCPStore(host, 0, None, True, timeout=datetime.timedelta(seconds=60), wait_for_workers=False)
        self._inbox = StoreKV(server)  # vtx: ignore[VTX200] set before Thread.start; read by the caller after the join
        self.client.key_value_set(f"{PEER_ADDR_PREFIX}/{self.process_index}", f"{host}:{server.port}")
        self._receiver = threading.Thread(target=self._receive, daemon=True, name="vitax-torch-peer-receiver")
        self._receiver.start()
        return True

    def stop(self, drain: bool = True) -> None:
        """Stop the receiver, then one last pull of the guard's shard. A
        receiver that outlives its join still owns the store and
        `_received`: the last pull is skipped (with a line on stderr)
        rather than run beside it. vitax drains either way
        (vitax/checkpoint/peer.py:371-379)."""
        self._stop.set()
        joined = True
        if self._receiver is not None:
            joined = join_or_warn(self._receiver, timeout=self.poll_s + 60.0, what="peer receiver")
            self._receiver = None
        if drain and self._inbox is not None:
            if joined:
                self._drain_receive()
            else:
                print(f"vitax_torch.peer: the receiver from host {self.guard} is still running; skipping the final "
                      f"receive (the local store keeps its last pulled version)", file=sys.stderr, flush=True)

    def _drain_receive(self) -> None:
        """One last pull of the guard's newest publication, so an exit right
        after a joint save leaves the guard's last shard on disk."""
        try:
            self._pull(timeout_ms=max(int(min(self.poll_s, 0.5) * 1000), 100))
        except Exception as e:  # noqa: BLE001 - best effort
            print(f"vitax_torch.peer: final receive from host {self.guard} failed ({e}); local store keeps its "
                  f"last pulled version", file=sys.stderr, flush=True)

    def _pull(self, timeout_ms: int) -> None:
        prefix = f"{PEER_KEY_PREFIX}/{self.guard}"
        meta = _receive_into(self.store, self._inbox, prefix, timeout_ms, min_gen=self._received)
        if meta is not None:
            self._received = int(meta.get("gen", self._received))  # vtx: ignore[VTX200] caller pulls after the join
            for i in range(int(meta["n_chunks"])):      # spilled: free the memory they held
                self._inbox.key_value_delete(f"{prefix}/g{self._received}/c{i}")

    def _receive(self) -> None:
        timeout_ms = max(int(min(self.poll_s, 0.2) * 1000), 50)
        while not self._stop.wait(self.poll_s):
            try:
                self._pull(timeout_ms)
            except PeerRestoreError as e:
                # a read torn by the next publication: the next poll sees a whole gen
                print(f"vitax_torch.peer: receive from host {self.guard} failed ({e}); retrying next poll",
                      file=sys.stderr, flush=True)

    def _emit(self, kind: str, **payload) -> None:
        if self.on_event is None:
            return
        try:
            self.on_event(kind, payload)
        except Exception as e:  # noqa: BLE001 - observability must not break replication
            print(f"vitax_torch.peer: event sink failed ({type(e).__name__}: {e})", file=sys.stderr, flush=True)


# -- negotiated restore --------------------------------------------------------


@dataclass(frozen=True)
class RestorePlan:
    """An agreed peer restore: the version to load and its sidecar-shaped
    meta (step_in_epoch, process_count, stream_cursor) for
    control.elastic_resume_plan."""

    version: Tuple[int, int, int]
    meta: dict

    @property
    def epoch(self) -> int:
        return int(self.version[0])


def _complete_versions(holdings: Dict[int, dict]) -> List[Tuple]:
    """Versions whose every shard (of the version's own topology) is held."""
    by_version: Dict[Tuple, set] = {}
    for src, meta in holdings.items():
        v = tuple(int(x) for x in (meta.get("version") or ()))
        if len(v) == 3:
            by_version.setdefault(v, set()).add(int(src))
    return [v for v, srcs in by_version.items() if srcs >= set(range(v[2]))]


def _needed(version: Tuple[int, int, int], process_index: int, process_count: int) -> set:
    """The shards a process loads: its own under the version's topology,
    every one under another."""
    return {process_index} if version[2] == process_count else set(range(version[2]))


def negotiate_restore(store: PeerStore, *, process_index: int, process_count: int, client=None, collective=None,
                      dcp_frontier: Tuple[int, int] = (0, 0), stores=None, timeout_s: float = KV_TIMEOUT_S,
                      on_event=None) -> Optional[RestorePlan]:
    """Agree on a restore from the peer stores, or decline (None: the
    caller restores from the DCP checkpoint).

    Alone: the newest complete local version at least as fresh as the DCP
    frontier. In a group: publish holdings over `client` (the group's
    store), adopt process 0's choice, verify the held copies, then each
    holder serves the shards others need from its own store (`stores(pid)`:
    the store process pid serves, PeerReplicator.store_of) while this
    process fetches what it lacks, and the BIT_PEER_RESTORE fold: all enter
    the peer path or none. `timeout_s` bounds each wait that moves no bulk
    and each served chunk; the wait for the want lists adds the most bytes
    a process verifies over VERIFY_FLOOR_BYTES_S."""
    holdings = store.holdings()

    def best(cands: Sequence[Tuple]) -> Optional[Tuple]:
        ahead = [v for v in cands if progress_key(v[0], v[1]) >= tuple(dcp_frontier)]
        return max(ahead, key=lambda v: progress_key(v[0], v[1]), default=None)

    if process_count <= 1:
        v = best(_complete_versions(holdings))
        if v is None:
            return None
        meta = next(m for m in holdings.values() if tuple(m.get("version", ())) == v)
        return RestorePlan(version=v, meta=meta)

    if client is None or stores is None:
        return None
    wait_ms = max(int(timeout_s * 1000), 1000)
    # 1. every process publishes what it holds and the bytes it will verify
    mine = {src: list(meta.get("version", ())) for src, meta in holdings.items()}
    held_bytes = sum(int(meta.get("nbytes", 0)) for meta in holdings.values())
    client.key_value_set(f"{RESTORE_KEY_PREFIX}/holdings/{process_index}",
                         json.dumps({"held": mine, "nbytes": held_bytes}))
    # 2. process 0 reads them all, picks the version and its servers
    if process_index == 0:
        per_host: Dict[int, Dict[int, Tuple]] = {}
        most = 0
        for pid in range(process_count):
            try:
                raw = json.loads(client.blocking_key_value_get(f"{RESTORE_KEY_PREFIX}/holdings/{pid}", wait_ms))
                per_host[pid] = {int(s): tuple(int(x) for x in v) for s, v in raw["held"].items() if len(v) == 3}
                most = max(most, int(raw["nbytes"]))
            except Exception:  # noqa: BLE001 - a process with no store publishes nothing useful
                per_host[pid] = {}
        # every (src, version) pair a process holds counts: one process holds
        # its fresh self-spill beside a buddy replica a window behind
        coverage: Dict[Tuple, set] = {}
        for held in per_host.values():
            for src, ver in held.items():
                coverage.setdefault(ver, set()).add(src)
        v = best([ver for ver, srcs in coverage.items() if srcs >= set(range(ver[2]))])
        plan_wire = {"version": list(v) if v else None, "verify_s": most / VERIFY_FLOOR_BYTES_S, "holders": {
            str(src): min(pid for pid, held in per_host.items() if held.get(src) == v)
            for src in (range(v[2]) if v else ()) if any(held.get(src) == v for held in per_host.values())}}
        client.key_value_set(f"{RESTORE_KEY_PREFIX}/plan", json.dumps(plan_wire))
    try:
        plan_wire = json.loads(client.blocking_key_value_get(f"{RESTORE_KEY_PREFIX}/plan", wait_ms))
    except Exception:  # noqa: BLE001 - no plan within the deadline: the DCP path
        plan_wire = {"version": None}
    version = plan_wire.get("version")
    if version is None:
        agree(False, process_count, collective)
        return None
    version = tuple(int(x) for x in version)
    holders = {int(s): int(p) for s, p in (plan_wire.get("holders") or {}).items()}
    needed = _needed(version, process_index, process_count)
    # 3. verify every held copy now, while its server can still replace it;
    #    publish what this process needs and lacks (or holds corrupt)
    verified = set()
    for src in range(version[2]):
        if tuple(holdings.get(src, {}).get("version", ())) != version:
            continue
        try:
            store.load(src, expect_version=version)
            verified.add(src)
        except PeerRestoreError as e:
            print(f"vitax_torch.peer: locally held shard {src} failed verification: {e}", file=sys.stderr, flush=True)
    client.key_value_set(f"{RESTORE_KEY_PREFIX}/want/{process_index}", json.dumps(sorted(needed - verified)))
    want_ms = wait_ms + int(float(plan_wire.get("verify_s", 0.0)) * 1000)
    wants: Dict[int, set] = {}
    for pid in range(process_count):
        try:
            wants[pid] = set(json.loads(client.blocking_key_value_get(f"{RESTORE_KEY_PREFIX}/want/{pid}", want_ms)))
        except Exception:  # noqa: BLE001 - a process that published nothing wants nothing we can serve
            wants[pid] = set()
    # 4. serve what this process holds for others from its own store (a
    #    thread each, so two processes serving each other never wait on each
    #    other's window), and fetch what it lacks from its holders' stores
    local_ok = True
    served = [(src, pid) for pid in sorted(wants) if pid != process_index for src in sorted(wants[pid])
              if holders.get(src) == process_index]
    if any(src not in verified for src, _ in served):   # the designated server cannot read its copy
        local_ok = False
    servers = [threading.Thread(target=_serve_shard, daemon=True, name="vitax-torch-peer-serve",
                                args=(stores(process_index), store, holdings[src], _shard_prefix(src, pid), timeout_s))
               for src, pid in served if src in verified]
    for t in servers:
        t.start()
    for src in sorted(needed - verified):
        holder = holders.get(src)
        try:
            if holder is None or holder == process_index:
                raise PeerRestoreError(f"no other process holds a good copy of shard {src}")
            _fetch_shard(stores(holder), store, _shard_prefix(src, process_index), wait_ms, timeout_s)
        except Exception as e:  # noqa: BLE001 - a store error is a lost holder: a failed fetch
            print(f"vitax_torch.peer: fetch of shard {src} failed: {type(e).__name__}: {e}", file=sys.stderr,
                  flush=True)
            local_ok = False
    for t in servers:                   # each of its waits is bounded: it ends
        t.join()
    # 5. the all-processes gate; then the served keys a failed fetch left go
    agreed = agree(local_ok, process_count, collective)
    for src, pid in served:
        _drop_served(stores(process_index), _shard_prefix(src, pid), holdings.get(src, {}))
    if on_event is not None:
        try:
            on_event("control", {"event": "peer_restore_negotiated", "version": list(version),
                                 "agreed": bool(agreed), "local_ok": bool(local_ok)})
        except Exception as e:  # noqa: BLE001 - observability must not block the restore
            print(f"vitax_torch.peer: restore event sink failed ({type(e).__name__}: {e})", file=sys.stderr,
                  flush=True)
    if not agreed:
        return None
    metas = store.holdings()
    meta = next((metas[s] for s in sorted(needed) if tuple(metas.get(s, {}).get("version", ())) == version), None)
    if meta is None:
        return None
    return RestorePlan(version=version, meta=meta)


def _shard_prefix(src: int, pid: int) -> str:
    return f"{RESTORE_KEY_PREFIX}/data/{src}/to{pid}"


def _n_chunks(meta: dict) -> int:
    return -(-int(meta["nbytes"]) // CHUNK_BYTES)


def _serve_shard(kv, store: PeerStore, meta: dict, prefix: str, timeout_s: float) -> None:
    """A holder's side of one served shard, on its own thread: the meta,
    then the chunks, never more than SERVE_WINDOW of them waiting for the
    fetcher, which deletes each one it has spilled."""
    try:
        kv.key_value_set(f"{prefix}/meta", json.dumps(dict(meta, n_chunks=_n_chunks(meta))))
        for i, chunk in enumerate(store.chunks(int(meta["src"]), CHUNK_BYTES)):
            if i >= SERVE_WINDOW:
                key, deadline = f"{prefix}/c{i - SERVE_WINDOW}", time.monotonic() + timeout_s
                while kv.key_exists(key):
                    if time.monotonic() >= deadline:
                        raise PeerRestoreError(f"the fetcher took no chunk within {timeout_s:g}s")
                    time.sleep(0.002)
            kv.key_value_set(f"{prefix}/c{i}", chunk)
    except Exception as e:  # noqa: BLE001 - the fetcher's failed fetch vetoes the restore for all
        print(f"vitax_torch.peer: serving {prefix} failed: {type(e).__name__}: {e}", file=sys.stderr, flush=True)


def _fetch_shard(kv, store: PeerStore, prefix: str, meta_ms: int, timeout_s: float) -> None:
    """Stream one served shard into `store` (its crc32 checked), deleting
    each chunk once spilled; PeerRestoreError or the store's own error on a
    fault."""
    meta = json.loads(kv.blocking_key_value_get(f"{prefix}/meta", meta_ms))
    chunk_ms = max(int(timeout_s * 1000), 1000)

    def chunks():
        for i in range(int(meta["n_chunks"])):
            key = f"{prefix}/c{i}"
            chunk = kv.blocking_key_value_get_bytes(key, chunk_ms)
            kv.key_value_delete(key)
            yield chunk

    store.put_stream({k: v for k, v in meta.items() if k != "n_chunks"}, chunks())
    kv.key_value_delete(f"{prefix}/meta")


def _drop_served(kv, prefix: str, meta: dict) -> None:
    """A served shard's keys that a failed fetch left in the holder's store."""
    try:
        kv.key_value_delete(f"{prefix}/meta")
        for i in range(_n_chunks(meta) if "nbytes" in meta else 0):
            kv.key_value_delete(f"{prefix}/c{i}")
    except Exception as e:  # noqa: BLE001 - the store going away frees them too
        print(f"vitax_torch.peer: dropping {prefix} failed ({type(e).__name__}: {e})", file=sys.stderr, flush=True)


def agree(local_ok: bool, process_count: int, collective) -> bool:
    from vitax_torch.train.control import agree_peer_restore
    return agree_peer_restore(local_ok, process_count=process_count, collective=collective)


# -- restore -------------------------------------------------------------------


def _overlap(a: Sequence[Tuple[int, int]], b: Sequence[Tuple[int, int]]) -> Optional[List[Tuple[int, int]]]:
    box = [(max(a0, b0), min(a1, b1)) for (a0, a1), (b0, b1) in zip(a, b)]
    return box if all(lo < hi for lo, hi in box) or not box else None


def assemble_state(parts: Sequence[Tuple[dict, bytearray]], state):
    """Fill the run's state (its tensors, a DTensor's local shard) from peer
    blobs, in place, and return it. Each local shard must be covered by
    the shard boxes of `parts` (PeerRestoreError otherwise); a box held by
    several parts (a replicated leaf) is taken once."""
    from vitax_torch.checkpoint.io import train_state_dict
    from vitax_torch.checkpoint.snapshot import _index_of, flatten_state
    from vitax_torch.train.state import local
    per_path: Dict[str, Dict[Tuple, torch.Tensor]] = {}
    for meta, payload in parts:
        for path, shards in unpack_payload(meta, payload).items():
            dest = per_path.setdefault(path, {})
            for box, t in shards:
                dest.setdefault(box, t)
    target = train_state_dict(state)
    with torch.no_grad():
        for path, t in flatten_state(target):
            shards = per_path.get(path)
            if shards is None:
                raise PeerRestoreError(f"no peer shard covers leaf {path!r}")
            mine = _index_of(t)
            if mine is None:
                raise PeerRestoreError(f"leaf {path!r} is a strided shard (tp): no box to restore into")
            dst = local(t)
            covered, need = 0, dst.numel()
            for box, src in shards.items():
                inter = _overlap(box, mine)
                if inter is None:
                    continue
                s_idx = tuple(slice(lo - b0, hi - b0) for (lo, hi), (b0, _) in zip(inter, box))
                d_idx = tuple(slice(lo - m0, hi - m0) for (lo, hi), (m0, _) in zip(inter, mine))
                dst[d_idx].copy_(src[s_idx])
                n = 1
                for lo, hi in inter:
                    n *= hi - lo
                covered += n
            if covered < need:
                raise PeerRestoreError(f"leaf {path!r} only {covered}/{need} elements covered by peer shards — a "
                                       f"replica is missing")
    state.step = int(target["step"])
    return state


def restore_from_store(store: PeerStore, plan: RestorePlan, state):
    """Load and verify the plan's shards this process needs from the local
    store and fill the state; PeerRestoreError on any fault."""
    from vitax_torch.distributed import process_count, process_index
    parts = [store.load(src, expect_version=plan.version)
             for src in sorted(_needed(plan.version, process_index(), process_count()))]
    return assemble_state(parts, state)


def restore_state_preferring_peers(store: PeerStore, plan: RestorePlan, ckpt_dir: str, dcp_epoch: int, state,
                                   on_event=None, process_count: Optional[int] = None, collective=None):
    """The loop's restore when a peer plan was agreed: the peer shards,
    then a second BIT_PEER_RESTORE fold over the load's outcome, so a
    failure that only shows at the load sends every process to the DCP
    checkpoint together. Returns (state, info), info {"path": "peer" |
    "dcp", "epoch": the epoch restored, ...} for the restore event."""
    from vitax_torch.checkpoint import io as ckpt_io
    err = None
    try:
        state = restore_from_store(store, plan, state)
    except PeerRestoreError as e:
        err = e
    if agree(err is None, process_count if process_count is not None else _count(), collective):
        master_print(f"restored from PEER shards: version {list(plan.version)} ({plan.version[2]} replica(s) in "
                     f"{store.root}; zero checkpoint-directory reads)")
        return state, {"path": "peer", "epoch": plan.epoch, "step_in_epoch": int(plan.version[1])}
    if err is None:
        err = PeerRestoreError("a peer process vetoed after the post-agreement shard load — dropping to the DCP "
                               "checkpoint with the group")
    print(f"vitax_torch.peer: PEER RESTORE FAILED ({err}); falling back to the last committed DCP epoch",
          file=sys.stderr, flush=True)
    if on_event is not None:
        try:
            on_event("control", {"event": "peer_restore_failed", "version": list(plan.version), "error": str(err),
                                 "fallback_epoch": int(dcp_epoch)})
        except Exception as sink_err:  # noqa: BLE001 - observability must not mask the fallback
            print(f"vitax_torch.peer: restore event sink failed ({type(sink_err).__name__}: {sink_err})",
                  file=sys.stderr, flush=True)
    if dcp_epoch <= 0:
        raise RuntimeError("peer restore failed and no committed DCP checkpoint exists to fall back to") from err
    state, restored = ckpt_io.restore_state_with_fallback(ckpt_dir, dcp_epoch, state)
    return state, {"path": "dcp", "epoch": int(restored), "fallback_from": str(err)}


def _count() -> int:
    from vitax_torch.distributed import process_count
    return process_count()
