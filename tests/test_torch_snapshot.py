"""vitax_torch's zero-stall snapshots and peer replication against vitax's,
and the lost-rank drill.

- checkpoint/peer.py: ring_buddy / ring_guard, progress_key and
  store_frontier equal vitax's; supervise.run_progress equal vitax's on
  the same directories; negotiate_restore's choice equal vitax's on the
  same holdings (one process against the DCP frontier; two processes on
  threads with a fake KV and OR fold: mixed-version coverage, a corrupt
  held copy refetched, a sole corrupt copy declined together); the
  packed shard round trip, its crc32 and the peer_restore site; the
  restore's DCP fallback and the post-agreement veto.
- checkpoint/snapshot.py: staging reuses its buffers, a pipeline-written
  checkpoint restores bitwise (ckpt_write retried), submit returns before
  a slow write; train() under --zero_stall_ckpt ends bitwise the run
  without it, and under --replicate_steps resumes from its own peer store
  with no checkpoint-directory read.
- The drill: two ranks (gloo, RANK/WORLD_SIZE/MASTER_PORT as torchrun
  sets them) with --replicate_steps 2 --peer_heartbeat_s 1; rank 1's
  peer_loss at step 4; rank 0 exits 42 within peer_grace_s plus the
  deadline; rank 1's store deleted; the relaunched pair restores from
  rank 0's buddy copy (restore path "peer", 0 reads) and ends bitwise the
  uninterrupted two-rank run.
Tiny dims, float32, the CPU.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
import zlib

import pytest
import torch

from vitax_torch import faults
from vitax_torch.checkpoint import io as ckpt_io
from vitax_torch.checkpoint import peer
from vitax_torch.checkpoint.snapshot import SnapshotPipeline, flatten_state
from vitax_torch.config import Config
from vitax_torch.models.vit import build_model
from vitax_torch.ops.attention import make_attention_impl
from vitax_torch.train.control import BIT_PEER_RESTORE
from vitax_torch.train.state import make_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(image_size=16, patch_size=8, embed_dim=32, num_heads=2, num_blocks=2, num_classes=4, batch_size=8,
            dtype="float32", warmup_steps=2, lr=1e-3, weight_decay=0.1, clip_grad_norm=1.0)
RUN = dict(fake_data=True, num_epochs=2, steps_per_epoch=3, log_step_interval=1, eval_max_batches=1,
           test_epoch_interval=99, ckpt_epoch_interval=1, num_workers=1)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.uninstall()


def _state(seed=0, init=True):
    cfg = Config(**TINY, seed=seed)
    model = build_model(cfg, "cpu", attention_impl=make_attention_impl(cfg, "cpu"), init=init)
    state = make_train_state(model if init else model.to_empty(device="cpu"))
    for i, t in enumerate(list(state.mu.values()) + list(state.nu.values())):
        t.copy_(torch.full_like(t, 0.01 * (i + 1)))
    state.step, state.count = 5, torch.tensor(5, dtype=torch.int32)
    return state


def _assert_same(a, b):
    fa, fb = flatten_state(ckpt_io.train_state_dict(a)), flatten_state(ckpt_io.train_state_dict(b))
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert torch.equal(x, y), p


# --- ring, progress, frontiers against vitax's ----------------------------------------


@pytest.mark.parametrize("count", [1, 2, 3, 8])
def test_ring_and_progress_keys_match_vitax(count):
    from vitax.checkpoint import peer as jp
    for i in range(count):
        assert peer.ring_buddy(i, count) == jp.ring_buddy(i, count)
        assert peer.ring_guard(i, count) == jp.ring_guard(i, count)
    for e in range(4):
        for s in range(4):
            assert peer.progress_key(e, s) == jp.progress_key(e, s)


def _fake_meta(src, version):
    payload = json.dumps({"src": src, "v": list(version)}).encode() * 7
    return {"version": list(version), "src": int(src), "step_in_epoch": int(version[1]),
            "process_count": int(version[2]), "leaves": [], "crc32": zlib.crc32(payload) & 0xFFFFFFFF,
            "nbytes": len(payload)}, payload


def _put(module, root, src, version, corrupt=False):
    """A minimal valid replica (negotiation reads the meta and the crc32)
    through `module`'s own PeerStore; `corrupt` flips a byte of it."""
    store = module.PeerStore(root)
    store.put(*_fake_meta(src, version))
    if corrupt:
        blob = next(os.path.join(store.root, f"host_{src}", n) for n in os.listdir(os.path.join(store.root,
                                                                                                  f"host_{src}"))
                    if n.startswith("shard."))
        raw = bytearray(open(blob, "rb").read())
        raw[0] ^= 0xFF
        open(blob, "wb").write(bytes(raw))
    return store


def _dirs(tmp_path, name, layout):
    """One (sidecar, peer store) layout written for vitax and for the port
    under tmp_path/<name>/{jax,port}."""
    from vitax.checkpoint import peer as jp
    roots = {}
    for pkg, module in (("jax", jp), ("port", peer)):
        root = tmp_path / name / pkg
        ckpt = root / "ckpt"
        for epoch, step in layout.get("committed", ()):
            os.makedirs(ckpt / f"epoch_{epoch}")
            (ckpt / f"epoch_{epoch}" / "commit_success.txt").write_text("ok")
            if step:
                (ckpt / f"epoch_{epoch}.resume.json").write_text(json.dumps({"step_in_epoch": step}))
        os.makedirs(ckpt / "epoch_9")           # torn: no marker
        for proc, src, version in layout.get("peers", ()):
            _put(module, str(root / "peers" / f"p{proc}"), src, version)
        roots[pkg] = root
    return roots


@pytest.mark.parametrize("layout", [
    {}, {"committed": [(1, 0), (2, 3)]}, {"peers": [(0, 0, (2, 0, 1))]},
    {"committed": [(2, 2)], "peers": [(0, 0, (2, 0, 2)), (0, 1, (2, 0, 2)), (1, 1, (1, 3, 2))]},
    {"committed": [(3, 0)], "peers": [(0, 0, (2, 2, 1))]}], ids=["empty", "dcp", "peer", "both", "dcp_ahead"])
def test_frontiers_match_vitax(tmp_path, layout):
    from vitax import supervise as js
    from vitax.checkpoint import peer as jp
    from vitax_torch import supervise
    roots = _dirs(tmp_path, "f", layout)
    assert peer.store_frontier(str(roots["port"] / "peers")) == jp.store_frontier(str(roots["jax"] / "peers"))
    for peer_root in ("peers", ""):
        ours = supervise.run_progress(str(roots["port"] / "ckpt"), str(roots["port"] / peer_root) if peer_root else "")
        theirs = js.run_progress(str(roots["jax"] / "ckpt"), str(roots["jax"] / peer_root) if peer_root else "")
        assert ours == theirs


# --- negotiation against vitax's ------------------------------------------------------


@pytest.mark.parametrize("frontier", [(0, 0), (2, 0), (2, 3), (3, 0)])
def test_single_process_choice_matches_vitax(tmp_path, frontier):
    from vitax.checkpoint import peer as jp
    plans = []
    for pkg, module in (("jax", jp), ("port", peer)):
        root = str(tmp_path / pkg)
        for src, version in ((0, (1, 0, 1)), (1, (2, 2, 2)), (0, (2, 2, 2))):
            store = _put(module, root, src, version)       # host_0 ends at (2, 2, 2): a complete 2-process version
        kw = {"orbax_frontier": frontier} if module is jp else {"dcp_frontier": frontier}
        plan = module.negotiate_restore(store, process_index=0, process_count=1, **kw)
        plans.append(None if plan is None else plan.version)
    assert plans[0] == plans[1]


class FakeKV:
    """The KV over a dict, both packages' method names (the port's bytes
    get and delete too)."""

    def __init__(self):
        self._d, self._cond = {}, threading.Condition()

    def key_value_set(self, key, value, allow_overwrite=False):
        with self._cond:
            self._d[key] = value
            self._cond.notify_all()

    def blocking_key_value_get(self, key, timeout_ms):
        deadline = time.monotonic() + timeout_ms / 1000.0
        with self._cond:
            while key not in self._d:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(key)
                self._cond.wait(remaining)
            return self._d[key]

    blocking_key_value_get_bytes = blocking_key_value_get

    def key_value_delete(self, key):
        with self._cond:
            self._d.pop(key, None)

    def key_exists(self, key):
        with self._cond:
            return key in self._d


class OrFold:
    """A per-round OR collective across n threads."""

    def __init__(self, n):
        self.n, self._cond, self._words, self._done = n, threading.Condition(), [], []

    def __call__(self, word):
        with self._cond:
            rnd = len(self._done)
            self._words.append(int(word))
            if len(self._words) == self.n:
                folded = 0
                for w in self._words:
                    folded |= w
                self._done.append(folded)
                self._words = []
                self._cond.notify_all()
            elif not self._cond.wait_for(lambda: len(self._done) > rnd, timeout=30):
                raise TimeoutError("OR fold never completed")
            return self._done[rnd]


def _negotiate_two(module, stores, timeout_s=5.0):
    """Both processes on threads over one group KV; the port's holders
    serve from KVs of their own (PeerReplicator.store_of's part)."""
    kv, fold, own = FakeKV(), OrFold(2), [FakeKV(), FakeKV()]
    results, errors = [None, None], [None, None]
    kw = {"stores": own.__getitem__} if module is peer else {}

    def run(pid):
        try:
            results[pid] = module.negotiate_restore(stores[pid], process_index=pid, process_count=2, client=kv,
                                                    collective=fold, timeout_s=timeout_s, **kw)
        except BaseException as e:  # noqa: BLE001 - raised by the assert below
            errors[pid] = e

    threads = [threading.Thread(target=run, args=(pid,)) for pid in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert errors == [None, None], errors
    assert not [k for kv_own in own for k in kv_own._d]      # every served chunk deleted once spilled
    return [None if p is None else p.version for p in results]


@pytest.mark.parametrize("case", ["mixed_versions", "refetch_corrupt", "sole_copy_corrupt", "lost_store"])
def test_two_process_choice_matches_vitax(tmp_path, monkeypatch, case):
    """The same holdings through both packages' negotiation: the same agreed
    version (or the same refusal) on both processes; after it every store
    load-verifies the version its process needs, and the holders' stores
    hold no served chunk (8-byte chunks, a window of 2: a served shard
    waits on its fetcher)."""
    from vitax.checkpoint import peer as jp
    monkeypatch.setattr(peer, "CHUNK_BYTES", 8)
    monkeypatch.setattr(peer, "SERVE_WINDOW", 2)
    new, old = (1, 4, 2), (1, 2, 2)
    layouts = {"mixed_versions": [(0, 0, new, False), (0, 1, old, False), (1, 1, new, False), (1, 0, old, False)],
               "refetch_corrupt": [(0, 0, new, False), (0, 1, new, False), (1, 1, new, True)],
               "sole_copy_corrupt": [(0, 0, new, False), (1, 1, new, True)],
               "lost_store": [(0, 0, new, False), (0, 1, new, False)]}[case]
    chosen = []
    for pkg, module in (("jax", jp), ("port", peer)):
        stores = [module.PeerStore(str(tmp_path / pkg / f"p{i}")) for i in (0, 1)]
        for proc, src, version, corrupt in layouts:
            _put(module, stores[proc].root, src, version, corrupt)
        chosen.append(_negotiate_two(module, stores, timeout_s=1.0 if case == "sole_copy_corrupt" else 5.0))
        if module is peer and chosen[-1][0] is not None:
            for i, store in enumerate(stores):
                store.load(i, expect_version=chosen[-1][i])
    assert chosen[0] == chosen[1]
    assert chosen[1] == ([None, None] if case == "sole_copy_corrupt" else [new, new])


# --- the packed shards ----------------------------------------------------------------


def test_pack_store_load_unpack_round_trip_and_checksum(tmp_path):
    state = _state()
    pipe = SnapshotPipeline()
    try:
        snap = pipe.stage(state, epoch=2, step_in_epoch=3, stream_cursor={"epoch": 2})
        meta, payload = peer.pack_snapshot(snap, src=0)
        snap.release()
    finally:
        pipe.close()
    assert meta["version"] == [2, 3, 1] and meta["stream_cursor"] == {"epoch": 2}
    assert meta["nbytes"] == sum(len(p) for p in payload) == sum(
        t.numel() * t.element_size() for _, t in flatten_state(ckpt_io.train_state_dict(state)))
    store = peer.PeerStore(str(tmp_path / "p0"))
    store.put(meta, payload)
    assert list(store.holdings()) == [0]
    got_meta, got = store.load(0, expect_version=(2, 3, 1))
    restored = _state(seed=1)
    peer.assemble_state([(got_meta, got)], restored)
    _assert_same(restored, state)
    with pytest.raises(peer.PeerRestoreError, match="version"):
        store.load(0, expect_version=(2, 0, 1))
    store.put(dict(meta, src=1), payload)               # the site's index is the source process
    faults.install('{"site": "peer_restore", "action": "oserror", "at": 1}')
    with pytest.raises(peer.PeerRestoreError, match="unreadable"):
        store.load(1)
    store.load(0)
    faults.uninstall()
    blob = os.path.join(store.root, "host_0", "shard.bin")
    raw = bytearray(open(blob, "rb").read())
    raw[100] ^= 0x01
    open(blob, "wb").write(bytes(raw))
    with pytest.raises(peer.PeerRestoreError, match="checksum"):
        store.load(0)
    meta_half = dict(meta, leaves=meta["leaves"][:3])
    with pytest.raises(peer.PeerRestoreError, match="no peer shard covers"):
        peer.assemble_state([(meta_half, got)], _state(seed=1))


def test_restore_falls_back_to_dcp_and_post_agreement_veto(tmp_path):
    state = _state()
    d = str(tmp_path / "ckpt")
    ckpt_io.save_state(d, 1, state, wait=True)
    store = peer.PeerStore(str(tmp_path / "p0"))
    pipe = SnapshotPipeline()
    snap = pipe.stage(_state(seed=2), epoch=2, step_in_epoch=1)
    store.put(*peer.pack_snapshot(snap, src=0))
    snap.release()
    pipe.close()
    plan = peer.negotiate_restore(store, process_index=0, process_count=1, dcp_frontier=(3, 0))
    assert plan is None                                  # behind the DCP frontier: no peer plan
    plan = peer.negotiate_restore(store, process_index=0, process_count=1, dcp_frontier=(2, 0))
    assert plan.version == (2, 1, 1) and plan.meta["step_in_epoch"] == 1
    events = []
    blob = os.path.join(store.root, "host_0", "shard.bin")
    good = open(blob, "rb").read()
    open(blob, "wb").write(good[:-1] + bytes([good[-1] ^ 1]))     # the replica rots after the agreement
    restored, info = peer.restore_state_preferring_peers(store, plan, d, 1, _state(seed=1, init=True),
                                                         on_event=lambda k, p: events.append((k, p["event"])))
    open(blob, "wb").write(good)
    assert info["path"] == "dcp" and info["epoch"] == 1 and ("control", "peer_restore_failed") in events
    _assert_same(restored, state)
    vetoed, info = peer.restore_state_preferring_peers(store, plan, d, 1, _state(seed=1), process_count=2,
                                                       collective=lambda w: w | BIT_PEER_RESTORE)
    assert info["path"] == "dcp"                         # a peer's veto sends this process to DCP too
    _assert_same(vetoed, state)
    fine, info = peer.restore_state_preferring_peers(store, plan, d, 1, _state(seed=1), process_count=2,
                                                     collective=lambda w: w)
    assert info == {"path": "peer", "epoch": 2, "step_in_epoch": 1}
    _assert_same(fine, _state(seed=2))
    os.remove(blob)
    with pytest.raises(RuntimeError, match="no committed DCP checkpoint"):
        peer.restore_state_preferring_peers(store, plan, d, 0, _state(seed=1))


# --- the pipeline ---------------------------------------------------------------------


def test_staging_reuses_buffers_and_counts_the_stall():
    state = _state()
    pipe = SnapshotPipeline(max_buffer_sets=2)
    try:
        a = pipe.stage(state, epoch=1)
        bufs = [a.buffers(i) for i in range(len(a.specs))]
        a.release()
        b = pipe.stage(state, epoch=1, step_in_epoch=2)
        assert all(b.buffers(i) is bufs[i] for i in range(len(bufs))) and b.version == (1, 2, 1)
        assert pipe.consume_stall_s() > 0.0 and pipe.consume_stall_s() == 0.0
        for (_, t), buf in zip(flatten_state(ckpt_io.train_state_dict(state)), bufs):
            assert torch.equal(t, buf)
        b.release()
    finally:
        pipe.close()


def test_pipeline_checkpoint_restores_bitwise_through_a_retried_write(tmp_path, monkeypatch):
    monkeypatch.setenv("VITAX_SAVE_RETRY_BACKOFF_S", "0.01")
    faults.install('{"site": "ckpt_write", "action": "oserror", "at": 1}')
    state, d = _state(), str(tmp_path / "ckpt")
    pipe = SnapshotPipeline()
    try:
        pipe.submit(state, epoch=1, step_in_epoch=2, persist_to=d, wait=True, extra_meta={"replicate_steps": 2})
    finally:
        pipe.close()
    assert ckpt_io.committed_epochs(d) == [1]
    assert ckpt_io.load_resume_meta(d, 1) == {"step_in_epoch": 2, "process_count": 1, "replicate_steps": 2}
    restored = ckpt_io.restore_state(d, 1, _state(seed=1))
    _assert_same(restored, state)


def test_submit_returns_before_a_slow_write(tmp_path, monkeypatch):
    release = threading.Event()
    real = ckpt_io.write_host_state
    monkeypatch.setattr(ckpt_io, "write_host_state", lambda *a, **k: (release.wait(10), real(*a, **k)))
    state, d = _state(), str(tmp_path / "ckpt")
    pipe = SnapshotPipeline()
    try:
        t0 = time.perf_counter()
        pipe.submit(state, epoch=1, persist_to=d)
        assert time.perf_counter() - t0 < 2.0 and ckpt_io.committed_epochs(d) == []
        release.set()
        pipe.drain()
        assert ckpt_io.committed_epochs(d) == [1]
    finally:
        release.set()
        pipe.close()


def test_zero_stall_and_peer_resume_in_train(tmp_path):
    """train() under --zero_stall_ckpt ends bitwise the run without it (its
    records carry the saves' stalls); its epoch-2 checkpoint restores
    bitwise; a --replicate_steps run stopped after epoch 1 resumes from its
    own peer store (restore path "peer", no checkpoint-directory read) and
    ends bitwise too."""
    from vitax_torch.train.loop import train
    base = train(Config(**TINY, **RUN, ckpt_dir=str(tmp_path / "base")).validate(), "cpu")
    records = []
    zs = train(Config(**TINY, **RUN, ckpt_dir=str(tmp_path / "zs"), zero_stall_ckpt=True).validate(), "cpu",
               records=records)
    _assert_same(zs, base)
    assert [r["epoch"] for r in records if "ckpt_stall_s" in r] == [1, 2]
    _assert_same(ckpt_io.restore_state(str(tmp_path / "zs"), 2, _state(seed=1)), base)
    d, m = str(tmp_path / "peer"), str(tmp_path / "m")
    train(Config(**TINY, **RUN, ckpt_dir=d, replicate_steps=2, max_steps=3).validate(), "cpu")
    shutil.rmtree(os.path.join(d, "epoch_1"))           # no DCP epoch: the peer store is the only source
    resumed = train(Config(**TINY, **RUN, ckpt_dir=d, replicate_steps=2, resume_epoch=-1, metrics_dir=m).validate(),
                    "cpu")
    _assert_same(resumed, base)
    restore = [json.loads(ln) for ln in open(os.path.join(m, "metrics.jsonl")) if '"restore"' in ln]
    assert [(r["path"], r["epoch"], r["dcp_reads"]) for r in restore] == [("peer", 1, 0)]
    assert {r.get("kind") for r in map(json.loads, open(os.path.join(m, "metrics.jsonl")))} >= {"peer_replication"}


# --- the lost-rank drill --------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pair(root, *extra):
    """Rank 0 and rank 1 of the train CLI as torchrun would start them:
    (rc, seconds from start to exit, stdout+stderr) a rank."""
    port, flags = _free_port(), ["--device", "cpu", "--fake_data", "--resume_epoch", "-1",
                                 "--ckpt_dir", str(root / "ckpt"), "--metrics_dir", str(root / "m"),
                                 "--replicate_steps", "2", *extra]
    for k, v in {**TINY, **RUN}.items():
        if k != "fake_data":
            flags += [f"--{k}", str(v)]
    t0 = time.monotonic()
    procs = [subprocess.Popen([sys.executable, "-m", "vitax_torch.train", *flags], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), VITAX_CKPT_SYNC="1"))
             for r in (0, 1)]
    ends = [None, None]
    while any(e is None for e in ends):
        for r, p in enumerate(procs):
            if ends[r] is None and p.poll() is not None:
                ends[r] = time.monotonic() - t0
        time.sleep(0.02)
    return [(p.returncode, ends[r], p.stdout.read()) for r, p in enumerate(procs)]


def test_two_rank_lost_peer_bounded_exit_and_peer_restore(tmp_path):
    base = _pair(tmp_path / "base")
    assert [rc for rc, _, _ in base] == [0, 0], base[0][2][-3000:]
    lost = _pair(tmp_path / "lost", "--peer_heartbeat_s", "1", "--peer_grace_s", "3",
                 "--fault_plan", '{"site": "step", "at": 4, "action": "peer_loss", "process": 1}')
    (rc0, t0, out0), (rc1, t1, _) = lost
    assert rc1 == -9 and rc0 == 42, out0[-3000:]
    assert t0 - t1 < 3.0 + 3.0 + 2.0                     # grace, then the plane's own deadline, with slack
    assert "vitax_torch.control: peer 1 lost" in out0
    stores = tmp_path / "lost" / "ckpt" / "peerstore"
    assert sorted(os.listdir(stores / "p0")) == ["host_0", "host_1"]     # its own and its guard's (rank 1)
    shutil.rmtree(stores / "p1")                          # rank 1's host is gone with its disk
    again = _pair(tmp_path / "lost", "--peer_heartbeat_s", "1", "--peer_grace_s", "3")
    assert [rc for rc, _, _ in again] == [0, 0], again[0][2][-3000:]
    log = [json.loads(ln) for ln in open(tmp_path / "lost" / "m" / "metrics.jsonl")]
    restore = [e for e in log if e.get("kind") == "restore"]
    assert [(e["path"], e["epoch"], e["dcp_reads"]) for e in restore] == [("peer", 1, 0)]
    assert [e.get("event") for e in log if e.get("kind") == "control"][:1] == ["peer_loss"]
    a, b = (ckpt_io.read_state(str(tmp_path / name / "ckpt"), 2) for name in ("base", "lost"))
    assert a["step"] == b["step"] == 6 and torch.equal(a["count"], b["count"])
    for group in ("model", "mu", "nu"):
        assert a[group].keys() == b[group].keys()
        assert all(torch.equal(a[group][k], b[group][k]) for k in a[group]), group
