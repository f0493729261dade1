"""Multi-host launcher (vitax/launch.py): run one command on every GPU host.

vitax reaches every TPU-VM worker through `gcloud compute tpus tpu-vm ssh
--worker=all`. GPU hosts have no such fan-out, so this runs `ssh` to each
host of `--hosts` in parallel. Every host gets the same command, with

    NNODES       the number of hosts
    NODE_RANK    this host's index in --hosts
    MASTER_ADDR  the first host (the rendezvous; any user@ stripped)
    MASTER_PORT  --master_port

exported, and `$NNODES`, `$NODE_RANK`, `$MASTER_ADDR` and `$MASTER_PORT`
(or `${...}`) in the command's arguments replaced by the host's values, so
one command line starts torchrun on every host:

    python -m vitax_torch.launch --hosts gpu0,gpu1 --env PYTHONUNBUFFERED=1 -- \\
        torchrun --nnodes '$NNODES' --node_rank '$NODE_RANK' --nproc_per_node 8 \\
        --master_addr '$MASTER_ADDR' --master_port '$MASTER_PORT' -m vitax_torch.train --fake_data ...

(quote the $ so the local shell leaves it alone). As in vitax:
    --env KEY=VAL ...  exported on every host
    --workdir DIR      cd there first (a leading ~ is left to the remote shell)
    --restart          kill stale training processes on every host first, in
                       an ssh round of its own
    --max_restarts N   when any host exits non-zero, rerun the kill and launch
                       rounds, up to N times
    --logfile PATH     tee the hosts' combined output (each line tagged with
                       its host) to a local file
    --dry_run          print the ssh commands without running them
"""

from __future__ import annotations

import argparse
import re
import shlex
import subprocess
import sys
import threading
from typing import List, Optional

# The bracketed first character keeps the pattern from matching the command
# line of the shell that carries it (which holds the literal string).
RESTART_CMD = "pkill -f '[v]itax_torch.train' || true; sleep 1"
_HOST_VARS = re.compile(r"\$(?:\{(NNODES|NODE_RANK|MASTER_ADDR|MASTER_PORT)\}|(NNODES|NODE_RANK|MASTER_ADDR|MASTER_PORT)\b)")


def _quote_workdir(workdir: str) -> str:
    # keep a leading ~/ unquoted so the remote shell expands it
    if workdir.startswith("~/"):
        return "~/" + shlex.quote(workdir[2:])
    if workdir == "~":
        return "~"
    return shlex.quote(workdir)


def host_env(hosts: List[str], rank: int, master_port: int) -> dict:
    """NNODES, NODE_RANK, MASTER_ADDR and MASTER_PORT of host `rank`."""
    return {"NNODES": str(len(hosts)), "NODE_RANK": str(rank), "MASTER_ADDR": hosts[0].rpartition("@")[2],
            "MASTER_PORT": str(master_port)}


def build_remote_command(cmd: List[str], env: List[str], workdir: str, host_vars: Optional[dict] = None) -> str:
    """The shell line one host runs: cd, the exports (host_vars, then the
    --env pairs), then `cmd` with the host's variables substituted, every
    word quoted."""
    host_vars = host_vars or {}
    exports = [f"{k}={v}" for k, v in host_vars.items()] + list(env)
    words = [_HOST_VARS.sub(lambda m: host_vars.get(m.group(1) or m.group(2), m.group(0)), c) for c in cmd]
    return (f"cd {_quote_workdir(workdir)} && " + "".join(f"export {shlex.quote(e)}; " for e in exports)
            + " ".join(shlex.quote(w) for w in words))


def _pump(host: str, stream, out, log, lock: threading.Lock) -> None:
    for line in stream:
        tagged = f"[{host}] ".encode() + line
        with lock:
            out.write(tagged)
            out.flush()
            if log is not None:
                log.write(tagged)


def _run_round(argvs: List[List[str]], hosts: List[str], logfile: Optional[str]) -> int:
    """Run one ssh command a host, all at once, to completion; each output
    line goes to stdout (and `logfile`) tagged with its host. Returns 0, or
    the exit code of the first host, in --hosts order, that failed."""
    lock = threading.Lock()
    log = open(logfile, "ab") if logfile else None
    try:
        procs = [subprocess.Popen(a, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for a in argvs]
        pumps = [threading.Thread(target=_pump, args=(h, p.stdout, sys.stdout.buffer, log, lock), daemon=True)
                 for h, p in zip(hosts, procs)]
        for t in pumps:
            t.start()
        rcs = [p.wait() for p in procs]
        for t in pumps:
            t.join()
    finally:
        if log is not None:
            log.close()
    return next((rc for rc in rcs if rc != 0), 0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--hosts", required=True, help="comma-separated hosts ([user@]host); the first is MASTER_ADDR")
    p.add_argument("--ssh", default="ssh", help="the ssh command, options included (default %(default)s)")
    p.add_argument("--master_port", type=int, default=29500, help="MASTER_PORT on every host (default %(default)s)")
    p.add_argument("--env", action="append", default=[], metavar="KEY=VAL")
    p.add_argument("--restart", action="store_true", help="kill stale training processes on every host first")
    p.add_argument("--max_restarts", type=int, default=3,
                   help="relaunch rounds after a non-zero host exit (0 disables them)")
    p.add_argument("--workdir", default="~/vitax")
    p.add_argument("--logfile", default=None)
    p.add_argument("--dry_run", action="store_true", help="print the ssh commands without running them")
    p.add_argument("cmd", nargs=argparse.REMAINDER, help="-- command to run on every host")
    args = p.parse_args(argv)

    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        p.error("no command given (append: -- torchrun ... -m vitax_torch.train ...)")
    hosts = [h for h in args.hosts.split(",") if h]
    if not hosts:
        p.error("--hosts names no host")
    ssh = shlex.split(args.ssh)
    launch = [ssh + [h, build_remote_command(cmd, args.env, args.workdir, host_env(hosts, i, args.master_port))]
              for i, h in enumerate(hosts)]
    restart = [ssh + [h, RESTART_CMD] for h in hosts]

    rc = 1
    for attempt in range(args.max_restarts + 1):
        if args.restart or attempt > 0:
            # a round of its own, so the pattern cannot match (and kill) the
            # shell that carries the training command; before every relaunch,
            # so half-dead workers of a failed round free their cards
            for a in restart:
                print("restarting: " + shlex.join(a), flush=True)
            if not args.dry_run:
                _run_round(restart, hosts, args.logfile)
        for a in launch:
            print("launching: " + shlex.join(a), flush=True)
        if args.dry_run:
            return 0
        rc = _run_round(launch, hosts, args.logfile)
        if rc == 0:
            return 0
        print(f"a host exited with rc={rc} (attempt {attempt + 1}/{args.max_restarts + 1})", flush=True)
    print(f"giving up after {args.max_restarts + 1} attempts", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
