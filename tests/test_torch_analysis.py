"""vitax_torch.analysis.rules, .trace and .check against vitax's rules.

The port's RULES are vitax's in id, name, severity and kind, and their
config gates give vitax's verdict on each of vitax's arm configs, built
from the same overrides through both Configs. Each of VTX-R001-R010 has a
program that passes and a deliberately broken one that gives a finding,
as tests/test_analysis.py has for vitax: real programs (a recorded step, a
warmed engine) where one process builds them, hand-made evidence for the
sharded rules' broken cases. The sharded arms' passing cases come from the
check CLI over vitax's FAST_ARMS, which runs them in the slice's one gloo
group of two ranks. The op recorder changes nothing a step computes and
sees the blocks' recompute; the collective reader reads a trace's c10d ops
inside its step range. Last, tools/serve_bench.py drives the port's server.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from vitax.analysis import rules as jax_rules
from vitax_torch.analysis import rules, trace
from vitax_torch.analysis.rules import Program

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- the registry -----------------------------------------------------------

def test_rules_match_vitax_ids_names_severities_and_kinds():
    def table(rs):
        return [(r.id, r.name, r.severity, r.kinds) for r in rs]
    assert table(rules.RULES) == table(jax_rules.RULES)
    assert rules.ALL_ARMS == jax_rules.ALL_ARMS and rules.FAST_ARMS == jax_rules.FAST_ARMS
    assert rules.BASE_GEOMETRY == jax_rules.BASE_GEOMETRY and rules.TRAIN_ARMS == jax_rules.TRAIN_ARMS


@pytest.mark.parametrize("arm", jax_rules.ALL_ARMS)
def test_applies_to_gives_vitax_verdict_on_its_arm_configs(arm):
    mine, theirs = rules.arm_config(arm), jax_rules.arm_config(arm)
    assert [r.applies_to(mine) for r in rules.RULES] == [r.applies_to(theirs) for r in jax_rules.RULES]


# --- programs built in this process ------------------------------------------

@pytest.fixture(scope="module")
def dp_program():
    return rules.build_program("dp")


@pytest.fixture(scope="module")
def fused_dp_program():
    return rules.build_program("dp", fused_optimizer="on")


def test_dp_arm_is_clean(dp_program):
    ran, findings = rules.run_rules(dp_program)
    assert ran == ["VTX-R001", "VTX-R002"] and findings == []
    assert dp_program.launches.calls == {"fused_adamw": 1}
    assert dp_program.launches.launches == {} and dp_program.launches.builds == 0   # no kernel on the CPU


def test_r001_catches_a_host_read_in_the_step():
    def with_item(step):
        def s(state, batch):
            state, metrics = step(state, batch)
            metrics["loss"].item()
            return state, metrics
        return s
    bad = rules.build_program("dp", wrap_step=with_item)
    findings = rules.NO_HOST_TRANSFER.check(bad, bad.config)
    assert findings and "aten._local_scalar_dense" in findings[0].message


def test_r002_catches_a_state_leaf_moved_to_new_storage():
    def rebind(step):
        def s(state, batch):
            state, metrics = step(state, batch)
            p = next(state.model.parameters())
            p.data = p.data.clone()
            return state, metrics
        return s
    bad = rules.build_program("dp", wrap_step=rebind)
    findings = rules.DONATION_HONORED.check(bad, bad.config)
    assert len(findings) == 1 and "param/" in findings[0].details["key"]


def test_r008_holds_the_call_count_and_catches_a_tree_of_ops(fused_dp_program):
    ran, findings = rules.run_rules(fused_dp_program)
    assert ran == ["VTX-R001", "VTX-R002", "VTX-R008"] and findings == []
    # the plain version's ops ran inside the dispatcher's region
    assert any(r.region == "fused_adamw" and r.op == "aten.sqrt" for r in fused_dp_program.ops.rows)

    def adamw_outside(step):
        def s(state, batch):
            state, metrics = step(state, batch)
            with torch.no_grad():
                for p in state.model.parameters():
                    torch.sqrt(p.abs())          # a param-sized optimizer temporary outside the kernel
            return state, metrics
        return s
    bad = rules.build_program("dp", fused_optimizer="on", wrap_step=adamw_outside)
    findings = rules.FUSED_OPTIMIZER.check(bad, bad.config)
    assert findings and all("aten.sqrt" in f.message for f in findings)
    twice = Program(kind="train", arm="x", config=bad.config, ops=bad.ops,
                    launches=trace.Launches(calls={"fused_adamw": 2}))
    assert any("2 fused_clip_adamw calls" in f.message for f in rules.FUSED_OPTIMIZER.check(twice, bad.config))


def test_recording_changes_nothing_and_sees_the_recompute():
    from vitax_torch.train.state import build_optimizer, make_train_state
    from vitax_torch.train.step import make_train_step

    def run(record: bool, grad_ckpt: bool = True):
        cfg = rules.arm_config("dp", grad_ckpt=grad_ckpt)
        torch.manual_seed(0)
        model = rules._build_tower(cfg, torch.device("cpu"), None).train()
        optimizer, _ = build_optimizer(cfg, 10)
        state, step = make_train_state(model, optimizer), make_train_step(cfg, optimizer, "cpu")
        batch = rules.seeded_batch(cfg, cfg.batch_size, "cpu")
        step(state, batch)
        rec = trace.OpRecorder()
        if record:
            with rec:
                step(state, batch)
        else:
            step(state, batch)
        return [p.detach().clone() for p in model.parameters()], rec

    plain, _ = run(False)
    recorded, rec = run(True)
    assert all(torch.equal(a, b) for a, b in zip(plain, recorded))
    _, no_ckpt = run(True, grad_ckpt=False)
    # five forward LayerNorms (two a block and the final one), and under
    # grad_ckpt the blocks' four again in the recompute
    assert no_ckpt.count("aten.native_layer_norm") == 5
    assert rec.count("aten.native_layer_norm") == 9


def test_prepare_images_makes_its_constants_once_a_device():
    # on the card a tensor made from host values is a blocking copy: R001's
    # sync debug mode caught two in every step before the constants were kept
    from vitax_torch.train.step import prepare_images
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 4, 4, 3), dtype=np.uint8))
    first = prepare_images(x)
    with trace.OpRecorder() as rec:
        again = prepare_images(x)
    assert torch.equal(first, again)
    assert rec.count("aten.lift_fresh") == 0 and rec.host_syncs() == []


# --- serve programs ----------------------------------------------------------

@pytest.fixture(scope="module")
def serve_programs():
    return {arm: rules.build_program(arm) for arm in rules.SERVE_ARMS}


def test_serve_arms_are_clean(serve_programs):
    want = {"serve": ["VTX-R006"], "serve_quant": ["VTX-R006", "VTX-R007"],
            "serve_fp8": ["VTX-R006", "VTX-R007"], "serve_actquant": ["VTX-R006", "VTX-R007", "VTX-R009"]}
    for arm, program in serve_programs.items():
        ran, findings = rules.run_rules(program)
        assert ran == want[arm] and findings == [], arm


def test_r006_catches_an_unwarmed_bucket(serve_programs):
    eng = serve_programs["serve"].engine
    eng._warm.discard(eng.buckets[-1])
    try:
        findings = rules.SERVE_NO_RECOMPILE.check(serve_programs["serve"], serve_programs["serve"].config)
    finally:
        eng._warm.add(eng.buckets[-1])
    assert any("compile_count" in f.message for f in findings)
    assert any("was refused" in f.message for f in findings)


def test_r007_catches_a_weight_dequantized_at_load():
    from vitax_torch.ops.dequant_matmul import dequantize_leaf
    program = rules.build_program("serve_quant")
    model = program.engine.model
    name = next(n for n in program.engine.scales if n.startswith("blocks.0.mlp.fc1"))
    module = model.get_submodule(name[:-len(".qscale")])
    module.weight = dequantize_leaf(module.weight, module.qscale[:, None])
    findings = rules.QUANT_WEIGHTS_RESIDENT.check(program, program.config)
    assert any("resident as torch.float32" in f.message for f in findings)
    assert any("block-sized floating tensor" in f.message for f in findings)


def test_r009_catches_a_dequant_outside_the_kernel():
    from vitax_torch.models.vit import QuantLinear
    from vitax_torch.ops.dequant_matmul import dequantize_leaf
    program = rules.build_program("serve_actquant")
    for m in program.engine.model.modules():
        if isinstance(m, QuantLinear):
            m.quant_matmul = lambda x, w, s, act=True: x.float() @ dequantize_leaf(w, s[:, None]).t()
    findings = rules.FUSED_DEQUANT.check(program, program.config)
    assert any("0 dequant_matmul calls for 9" in f.message for f in findings)
    assert any("weight-sized dequant" in f.message for f in findings)


# --- the sharded rules' broken cases, on hand-made evidence ------------------

def _sharded(arm, **fields):
    return Program(kind="train", arm=arm, config=rules.arm_config(arm), mesh_shape={"fsdp": 2}, **fields)


def test_r003_catches_f32_gathers_and_a_reduce_in_the_wrong_type():
    n = 32 * 32
    good = [{"op": "all-gather", "dtype": "bf16", "numel": 6 * n, "ts": 1.0},
            {"op": "reduce-scatter", "dtype": "f32", "numel": 6 * n, "ts": 2.0},
            {"op": "all-gather", "dtype": "f32", "numel": 64, "ts": 3.0}]
    assert rules.COLLECTIVE_DTYPE.check(_sharded("zero3", collectives=good), rules.arm_config("zero3")) == []
    bad = good + [{"op": "all-gather", "dtype": "f32", "numel": 6 * n, "ts": 4.0},
                  {"op": "reduce-scatter", "dtype": "bf16", "numel": 6 * n, "ts": 5.0}]
    findings = rules.COLLECTIVE_DTYPE.check(_sharded("zero3", collectives=bad), rules.arm_config("zero3"))
    assert len(findings) == 2
    lost = rules.COLLECTIVE_DTYPE.check(_sharded("zero3", collectives=good[1:]), rules.arm_config("zero3"))
    assert "no block-sized all-gather" in lost[0].message


def test_r004_catches_a_serial_schedule_and_a_lost_gather():
    cfg = rules.arm_config("zero3_overlap")
    overlapped = {"gather_0": 1.0, "end_0": 10.0, "gather_1": 2.0, "end_1": 20.0}
    assert rules.GATHER_OVERLAP.check(_sharded("zero3_overlap", gather_order=overlapped), cfg) == []
    serial = {"gather_0": 1.0, "end_0": 10.0, "gather_1": 11.0, "end_1": 20.0}
    assert "regressed to serial" in rules.GATHER_OVERLAP.check(
        _sharded("zero3_overlap", gather_order=serial), cfg)[0].message
    lost = {"gather_0": 1.0, "end_0": 10.0, "gather_1": None, "end_1": 20.0}
    assert "hoisted or lost" in rules.GATHER_OVERLAP.check(_sharded("zero3_overlap", gather_order=lost), cfg)[0].message


def test_r005_catches_a_large_leaf_held_whole():
    cfg = rules.arm_config("zero3")
    leaves = [("param/blocks.0.mlp.fc1.weight", torch.zeros(128, 32)), ("param/norm.weight", torch.zeros(32))]
    findings = rules.NO_REPLICATED_LARGE.check(_sharded("zero3", state_leaves=leaves), cfg)
    assert [f.details["leaf"] for f in findings] == ["param/blocks.0.mlp.fc1.weight"]


def test_r010_catches_moments_changes_and_a_teacher_under_autograd():
    probe = rules.build_program("probe")
    assert rules.run_rules(probe) == (["VTX-R001", "VTX-R002", "VTX-R003", "VTX-R005", "VTX-R010"], [])
    assert probe.frozen_paths and not probe.frozen_changed

    def touch_backbone(step):
        def s(state, batch):
            state, metrics = step(state, batch)
            with torch.no_grad():
                state.model.patch_embed.proj.weight.add_(1.0)
            return state, metrics
        return s
    bad = rules.build_program("probe", wrap_step=touch_backbone)
    assert any("changed in a step" in f.message for f in rules.FROZEN_NOT_UPDATED.check(bad, bad.config))
    cfg = rules.arm_config("probe")
    leaked = Program(kind="train", arm="probe", config=cfg, frozen_paths=("blocks.0.norm1.weight",),
                     opt_moment_paths=("blocks.0.norm1.weight", "head.weight"))
    assert "moment exists" in rules.FROZEN_NOT_UPDATED.check(leaked, cfg)[0].message
    dcfg = rules.arm_config("distill")
    grad = Program(kind="train", arm="distill", config=dcfg, frozen_paths=("teacher.head.weight",),
                   teacher_grad_fn=(True,))
    assert "grad_fn" in rules.FROZEN_NOT_UPDATED.check(grad, dcfg)[0].message


# --- the collective reader ----------------------------------------------------

def test_collective_reader_reads_c10d_ops_inside_the_step(tmp_path):
    def op(name, ts, types, dims):
        return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": 1,
                "args": {"Input type": types, "Input Dims": dims}}
    events = [
        op("c10d::_allgather_base_", 5, ["c10::BFloat16", "c10::BFloat16"], [[6304], [3152]]),   # before the step
        {"ph": "X", "cat": "user_annotation", "name": "vitax_step_3", "ts": 10, "dur": 100},
        op("c10d::_allgather_base_", 20, ["c10::BFloat16", "c10::BFloat16"], [[6304], [3152]]),
        op("c10d::_reduce_scatter_base_", 30, ["float", "float"], [[66], [132]]),
        {"ph": "X", "cat": "user_annotation", "name": "FSDP::all_gather (blocks.1)", "ts": 21, "dur": 1},
        {"ph": "X", "cat": "user_annotation", "name": "FSDP::post_forward (blocks.0)", "ts": 25, "dur": 1},
        {"ph": "X", "cat": "user_annotation", "name": "FSDP::all_gather (blocks.0)", "ts": 15, "dur": 1},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert trace.collectives(str(path)) == [
        {"op": "all-gather", "dtype": "bf16", "numel": 6304, "ts": 20.0},
        {"op": "reduce-scatter", "dtype": "f32", "numel": 132, "ts": 30.0}]
    order = trace.forward_gather_order(trace.fsdp_ranges(str(path)), 2)
    assert order == {"gather_0": 15.0, "end_0": 25.0, "gather_1": 21.0, "end_1": None}


# --- the gate's CLI ----------------------------------------------------------

def _check(*args):
    return subprocess.run([sys.executable, "-m", "vitax_torch.analysis.check", "--device", "cpu", "--json", *args],
                          capture_output=True, text=True, timeout=600, cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")})


def test_check_cli_fast_arms_json_contract():
    proc = _check("--arms", *rules.FAST_ARMS)
    assert proc.returncode == 0, proc.stderr[-3000:]
    doc = json.loads(proc.stdout)
    assert set(doc) == {"schema", "arms", "findings", "errors", "concurrency", "ok"}
    assert doc["schema"] == 1 and doc["ok"] is True and doc["errors"] == {} and doc["findings"] == []
    assert doc["concurrency"] == {"ok": True, "findings": []}
    train = ["VTX-R001", "VTX-R002", "VTX-R003", "VTX-R005"]
    want = {"zero3_overlap": ["VTX-R001", "VTX-R002", "VTX-R003", "VTX-R004", "VTX-R005"],
            "fused": train + ["VTX-R008"], "probe": train + ["VTX-R010"], "distill": train + ["VTX-R010"],
            "serve": ["VTX-R006"], "serve_quant": ["VTX-R006", "VTX-R007"], "serve_fp8": ["VTX-R006", "VTX-R007"],
            "serve_actquant": ["VTX-R006", "VTX-R007", "VTX-R009"]}
    assert {a: v["rules_ran"] for a, v in doc["arms"].items()} == want
    assert all(set(v) == {"ok", "rules_ran", "findings"} and v["ok"] for v in doc["arms"].values())


def test_check_cli_fails_on_a_seeded_violation():
    proc = _check("--arms", "dp", "--seeded_violation", "host_sync")
    assert proc.returncode == 1, proc.stderr[-3000:]
    doc = json.loads(proc.stdout)
    assert doc["ok"] is False and doc["errors"] == {}
    assert {f["rule"] for f in doc["findings"]} == {"VTX-R001"}


# --- tools/serve_bench.py against the port's server --------------------------

def test_serve_bench_drives_the_port_server():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import serve_bench
    from vitax_torch.serve import start_server, stop_server
    program = rules.build_program("serve", serve_port=0)
    httpd, ctx = start_server(program.config, program.engine, port=0)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        summary = serve_bench.run_bench(url, concurrency=2, requests_per_worker=3,
                                        image_size=program.config.image_size, timeout=30.0)
        assert serve_bench.main(["--url", url, "--concurrency", "1", "--requests", "2",
                                 "--image_size", str(program.config.image_size), "--json"]) == 0
    finally:
        stop_server(httpd, ctx)
    assert summary["completed"] == 6 and summary["errors"] == 0 and summary["requests"] == 6
    for key in ("throughput_rps", "latency_s_p50", "latency_s_p95", "latency_s_p99", "elapsed_s", "shed"):
        assert key in summary
    assert not [t for t in threading.enumerate() if t.name == "vitax-torch-http" and t.is_alive()]
