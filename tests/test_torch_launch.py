"""vitax_torch.launch, the ssh launcher (the counterpart of vitax/launch.py,
tests/test_launch.py): the remote command's quoting and exports, the
per-host NNODES / NODE_RANK / MASTER_ADDR, ~ workdirs, a restart pattern
that does not match itself, the restart rounds and their budget,
--max_restarts 0 and --dry_run, with the rounds monkeypatched; then one
real parallel round through a stand-in ssh that runs the line locally."""

import re
import shlex
import stat

import pytest

import vitax_torch.launch as launch
from vitax_torch.launch import RESTART_CMD, build_remote_command, host_env, main


def test_build_remote_command_quotes_and_env():
    remote = build_remote_command(
        ["python3", "-m", "vitax_torch.train", "--data_dir", "/data/image net"],
        env=["PYTHONUNBUFFERED=1", "NCCL_DEBUG_SUBSYS=INIT GRAPH"], workdir="~/vitax")
    assert remote.startswith("cd ~/vitax && ")
    assert "export PYTHONUNBUFFERED=1;" in remote
    assert "export 'NCCL_DEBUG_SUBSYS=INIT GRAPH';" in remote      # a space: quoted
    assert "'/data/image net'" in remote                           # survives the remote shell


def test_every_host_gets_its_rank_and_the_first_host_as_master():
    hosts = ["alice@gpu0", "gpu1", "gpu2"]
    assert [host_env(hosts, r, 29600) for r in range(3)] == [
        {"NNODES": "3", "NODE_RANK": str(r), "MASTER_ADDR": "gpu0", "MASTER_PORT": "29600"} for r in range(3)]
    cmd = ["torchrun", "--nnodes", "$NNODES", "--node_rank=${NODE_RANK}", "--master_addr", "$MASTER_ADDR",
           "--master_port", "$MASTER_PORT", "-m", "vitax_torch.train", "--tag", "$NODE_RANKS"]
    remote = build_remote_command(cmd, ["A=1"], "/w", host_env(hosts, 2, 29600))
    assert "export NNODES=3; export NODE_RANK=2; export MASTER_ADDR=gpu0; export MASTER_PORT=29600; export A=1;" \
        in remote
    words = shlex.split(remote.split("; ")[-1])
    assert words == ["torchrun", "--nnodes", "3", "--node_rank=2", "--master_addr", "gpu0", "--master_port",
                     "29600", "-m", "vitax_torch.train", "--tag", "$NODE_RANKS"]   # a longer name is not ours


def test_workdir_tilde_expansion_preserved():
    assert build_remote_command(["true"], [], "~").startswith("cd ~ && ")
    assert build_remote_command(["true"], [], "~/a b").startswith("cd ~/'a b' && ")
    assert build_remote_command(["true"], [], "/opt/x").startswith("cd /opt/x && ")


def test_restart_pattern_does_not_match_itself():
    """The bracketed first character: pkill's regex must not match the shell
    line carrying it, or the kill round kills itself; it does match the
    torchrun and worker lines it is for."""
    pattern = "[v]itax_torch.train"
    assert pattern in RESTART_CMD
    assert re.search(pattern, RESTART_CMD) is None
    assert re.search(pattern, "python -m torch.distributed.run --nnodes 2 -m vitax_torch.train --fake_data")


def _fake_rounds(monkeypatch, rcs):
    """Replace the rounds: each launch round returns the next of `rcs`."""
    launches, restarts = [], []

    def run_round(argvs, hosts, logfile):
        if RESTART_CMD in argvs[0]:
            restarts.append(argvs)
            return 0
        launches.append(argvs)
        return rcs[len(launches) - 1]
    monkeypatch.setattr(launch, "_run_round", run_round)
    return launches, restarts


def test_restart_on_failure_relaunches_with_kill_round(monkeypatch, capsys):
    """A non-zero host exit runs a kill round on every host and relaunches,
    within --max_restarts; the retry succeeds without spending the budget."""
    launches, restarts = _fake_rounds(monkeypatch, [1, 0])
    rc = main(["--hosts", "h0,h1", "--max_restarts", "3", "--", "python3", "-m", "vitax_torch.train"])
    assert rc == 0
    assert len(launches) == 2 and len(restarts) == 1
    assert [a[-2] for a in restarts[0]] == ["h0", "h1"]            # every host, in order
    assert [a[:2] for a in launches[0]] == [["ssh", "h0"], ["ssh", "h1"]]
    assert "a host exited with rc=1" in capsys.readouterr().out


def test_restart_budget_exhausted_returns_failure(monkeypatch, capsys):
    launches, restarts = _fake_rounds(monkeypatch, [7, 7, 7])
    rc = main(["--hosts", "h0", "--max_restarts", "2", "--", "python3", "x.py"])
    assert rc == 7
    assert len(launches) == 3 and len(restarts) == 2               # initial + 2 restarts
    assert "giving up" in capsys.readouterr().out


def test_max_restarts_zero_disables_retry(monkeypatch):
    launches, restarts = _fake_rounds(monkeypatch, [3])
    rc = main(["--hosts", "h0,h1", "--max_restarts", "0", "--", "python3", "x.py"])
    assert rc == 3 and len(launches) == 1 and not restarts


def test_restart_flag_kills_first(monkeypatch):
    launches, restarts = _fake_rounds(monkeypatch, [0])
    assert main(["--hosts", "h0,h1", "--restart", "--", "python3", "x.py"]) == 0
    assert len(restarts) == 1 and len(launches) == 1


def test_dry_run_prints_the_ssh_commands(monkeypatch, capsys):
    monkeypatch.setattr(launch, "_run_round", lambda *a: pytest.fail("a dry run ran a round"))
    rc = main(["--hosts", "u@gpu0,gpu1", "--ssh", "ssh -o BatchMode=yes", "--restart", "--master_port", "29700",
               "--env", "PYTHONUNBUFFERED=1", "--dry_run", "--",
               "torchrun", "--node_rank", "$NODE_RANK", "-m", "vitax_torch.train", "--fake_data"])
    assert rc == 0
    out = capsys.readouterr().out
    lines = [ln[len("launching: "):] for ln in out.splitlines() if ln.startswith("launching: ")]
    assert len(lines) == 2 and sum(ln.startswith("restarting: ") for ln in out.splitlines()) == 2
    for rank, (line, host) in enumerate(zip(lines, ["u@gpu0", "gpu1"])):
        argv = shlex.split(line)
        assert argv[:4] == ["ssh", "-o", "BatchMode=yes", host]
        remote = argv[4]
        assert f"export NODE_RANK={rank};" in remote and "export MASTER_ADDR=gpu0;" in remote
        assert "export MASTER_PORT=29700;" in remote and "export PYTHONUNBUFFERED=1;" in remote
        assert remote.endswith(f"torchrun --node_rank {rank} -m vitax_torch.train --fake_data")


def test_a_real_round_runs_every_host_in_parallel(tmp_path, capsys):
    """Through a stand-in ssh (drops the host, runs the line with sh): each
    host's command sees its own exports in its workdir, the output is
    tagged by host in the log file, and a failing host fails the round."""
    fake_ssh = tmp_path / "fake_ssh"
    fake_ssh.write_text("#!/bin/sh\nshift\nexec sh -c \"$1\"\n")
    fake_ssh.chmod(fake_ssh.stat().st_mode | stat.S_IEXEC)
    work = tmp_path / "w d"
    work.mkdir()
    log = tmp_path / "run.log"
    script = "echo $NODE_RANK/$NNODES/$MASTER_ADDR/$KEY > out_$1.txt; echo hello $1"
    rc = main(["--hosts", "a,b", "--ssh", str(fake_ssh), "--workdir", str(work), "--env", "KEY=v w",
               "--max_restarts", "0", "--logfile", str(log), "--", "sh", "-c", script, "sh", "$NODE_RANK"])
    assert rc == 0
    assert [(work / f"out_{r}.txt").read_text().strip() for r in (0, 1)] == ["0/2/a/v w", "1/2/a/v w"]
    assert sorted(log.read_text().splitlines()) == ["[a] hello 0", "[b] hello 1"]
    assert "[b] hello 1" in capsys.readouterr().out
    rc = main(["--hosts", "a,b", "--ssh", str(fake_ssh), "--workdir", str(work), "--max_restarts", "0", "--",
               "sh", "-c", "exit $1", "sh", "$NODE_RANK"])
    assert rc == 1
