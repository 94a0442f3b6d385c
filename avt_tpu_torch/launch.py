"""Experiment launcher of the PyTorch port.

Counterpart of avt_tpu/launch.py (itself the reference's launch.py): reads a
TXT override file, expands its sweeps into run_id variants and runs
`avt_tpu_torch.train_net` on them, with the utility modes (tensorboard,
delete or serve the outputs, stop the runs, debug). Data parallelism is one
process per card (parallel/ddp.py), told its place by torch's rendezvous
variables: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK, in
place of the JAX package's JAX_COORDINATOR_ADDRESS.

Usage:
  python -m avt_tpu_torch.launch -c expts/02_ek100_avt_tsn.txt      # run all here
  python -m avt_tpu_torch.launch -c expts/02.txt -r 1                # one variant
  python -m avt_tpu_torch.launch -c expts/02.txt -g                  # debug mode
  python -m avt_tpu_torch.launch -c expts/02.txt --spawn 2           # 2 local ranks
  python -m avt_tpu_torch.launch -c expts/02.txt --print-cmd --nodes 2
  python -m avt_tpu_torch.launch -c expts/02.txt --slurm [--submit]  # sbatch array
  python -m avt_tpu_torch.launch -c expts/02.txt --tb | --delete | --kill | --folder

A card takes one NCCL rank; several ranks on one card need
dist_backend=gloo (an override), which carries CUDA tensors through the host.
With parallel.model_size=m (an override or a line of the file) the N ranks
form N/m data replicas of m tensor-parallel ranks each (parallel/mesh.py),
so m must divide N:
  python -m avt_tpu_torch.launch -c expts/02.txt --spawn 2 parallel.model_size=2
"""
from __future__ import annotations

import argparse
import os
import re
import shlex
import shutil
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

from avt_tpu_torch.config import expand_sweeps, parse_override, parse_overrides_file
from avt_tpu_torch.utils.logging import get_logger

OUTPUT_ROOT = "OUTPUTS"
TRAIN_MODULE = "avt_tpu_torch.train_net"


def output_dir_for(config_file: str) -> str:
    return os.path.join(OUTPUT_ROOT, Path(config_file).stem)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, local_rank: int, addr: str, port: int) -> dict:
    """torch's rendezvous variables for one rank."""
    return dict(MASTER_ADDR=addr, MASTER_PORT=str(port), WORLD_SIZE=str(world),
                RANK=str(rank), LOCAL_RANK=str(local_rank))


def _spawn_ranks(n: int, cmd_tail, log_dir: str, logger):
    """Spawns n local ranks on one rendezvous and waits for all; returns
    (return codes, per-rank log paths). A dead rank would leave the others
    waiting in their collectives, so any nonzero exit terminates the rest
    (their SIGTERM handler checkpoints at the next synchronised chunk)."""
    port = _free_port()
    os.makedirs(log_dir, exist_ok=True)
    procs = []
    try:
        for rank in range(n):
            env = dict(os.environ, **rank_env(rank, n, rank, "localhost", port))
            log_path = os.path.join(log_dir, f"rank{rank}.log")
            logf = open(log_path, "w")
            procs.append((subprocess.Popen([sys.executable, "-m", TRAIN_MODULE] + cmd_tail,
                                           env=env, stdout=logf, stderr=subprocess.STDOUT),
                          logf, log_path))
            logger.info("Spawned rank %d (pid %d) -> %s", rank, procs[-1][0].pid, log_path)
        rcs = [None] * n
        while any(rc is None for rc in rcs):
            for i, (p, _, _) in enumerate(procs):
                if rcs[i] is None:
                    rcs[i] = p.poll()
            if any(rc not in (None, 0) for rc in rcs):
                for i, (p, _, _) in enumerate(procs):
                    if rcs[i] is None:
                        p.terminate()
            time.sleep(0.2)
    finally:
        for p, logf, _ in procs:
            if p.poll() is None:  # interrupted: stop every rank before leaving
                p.terminate()
                p.wait()
            logf.close()
    return rcs, [lp for _, _, lp in procs]


def _bind_failed(log_paths, elapsed_s: float) -> bool:
    """Did the run die early because the rendezvous port was taken between
    choosing it and rank 0 binding it? A late failure is never one."""
    if elapsed_s > 600.0:
        return False
    markers = ("Address already in use", "EADDRINUSE")
    for log_path in log_paths:
        try:
            with open(log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - 8192))
                tail = f.read().decode(errors="replace")
        except OSError:
            continue
        if any(m in tail for m in markers):
            return True
    return False


SBATCH_TEMPLATE = """\
#!/bin/bash
# Generated by avt_tpu_torch.launch --slurm from {config_file}: one array task
# per sweep variant, {gpus} rank(s) a node on {nodes} node(s), requeued on a
# graceful-preemption exit up to max_num_timeout times
#SBATCH --job-name={job_name}
#SBATCH --nodes={nodes}
#SBATCH --ntasks-per-node={gpus}
#SBATCH --gpus-per-node={gpus}
#SBATCH --time={timeout_min}
#SBATCH --array={array_spec}
#SBATCH --requeue
#SBATCH --open-mode=append
#SBATCH --output={out_dir}/slurm-%A_%a.log
{partition_line}#SBATCH --signal=USR1@120

# SIGUSR1 reaches every task 120 s before the limit: train_net checkpoints at
# the next synchronised chunk and exits 143. The rendezvous port comes from
# the job id, so that jobs sharing a head node do not collide.
export MASTER_ADDR=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n1)
export MASTER_PORT=$((10000 + SLURM_JOB_ID % 50000))
srun --kill-on-bad-exit=1 bash -c {srun_body}
rc=$?
if [ "$rc" -eq 143 ] && [ "${{SLURM_RESTART_COUNT:-0}}" -lt {max_num_timeout} ]; then
  scontrol requeue "$SLURM_ARRAY_JOB_ID"_"$SLURM_ARRAY_TASK_ID"
fi
exit $rc
"""


def _launcher_param(variants, key: str, default):
    """A hydra.launcher.* value of the expt file, else default; a sweep over
    it raises, since one sbatch script has one value."""
    values = {repr(o.value) for variant in variants for o in variant
              if o.key == f"hydra.launcher.{key}"}
    if len(values) > 1:
        raise ValueError(f"hydra.launcher.{key} differs across the sweep ({sorted(values)}); "
                         "launch the variants separately with -r")
    val = next((o.value for o in variants[0] if o.key == f"hydra.launcher.{key}"), None)
    return default if val is None else val


def check_mesh(variants, extra, world: int, logger) -> None:
    """Logs what `world` ranks form under each variant's
    parallel.model_size (the extra overrides win over the file's), and
    raises when a model size does not divide them."""
    given = [o for o in map(parse_override, extra) if o.key == "parallel.model_size"]
    sizes = set()
    for variant in variants:
        found = given or [o for o in variant if o.key == "parallel.model_size"]
        sizes.add(int(found[-1].value) if found else 1)
    for m in sorted(sizes):
        if m < 1 or world % m:
            raise ValueError(f"parallel.model_size={m} does not divide the {world} ranks")
        if m == 1:
            logger.info("%d rank(s): %d data-parallel replica(s)", world, world)
        else:
            logger.info("%d ranks: %d data-parallel replica(s) of %d tensor-parallel ranks "
                        "(parallel.model_size=%d)", world, world // m, m, m)


def emit_sbatch(args, variants, out_dir: str, cmd_tail) -> str:
    """The sbatch array script for this experiment file; each task's ranks
    take SLURM_PROCID, SLURM_NTASKS and SLURM_LOCALID (setup_distributed
    reads them)."""
    partition = _launcher_param(variants, "partition", None)
    nodes = int(args.nodes or _launcher_param(variants, "nodes", 1))
    gpus = int(_launcher_param(variants, "gpus_per_node", 1))
    quoted_tail = " ".join(shlex.quote(str(el)) for el in cmd_tail)
    srun_body = (f"exec {shlex.quote(sys.executable)} -m {TRAIN_MODULE} {quoted_tail} "
                 "--run-id $SLURM_ARRAY_TASK_ID")
    return SBATCH_TEMPLATE.format(
        config_file=args.config_file,
        job_name=Path(args.config_file).stem,
        nodes=nodes,
        gpus=gpus,
        timeout_min=int(_launcher_param(variants, "timeout_min", 2880)),
        array_spec=(f"{args.run_id}-{args.run_id}" if args.run_id is not None
                    else f"0-{len(variants) - 1}"),
        out_dir=out_dir,
        partition_line=f"#SBATCH --partition={partition}\n" if partition else "",
        srun_body=shlex.quote(srun_body),
        max_num_timeout=int(_launcher_param(variants, "max_num_timeout", 3)),
    )


def _sweep_diff_labels(variants) -> list:
    """One label a variant, showing only the overrides that differ across
    the sweep (the reference's subselect_dict_keys_diff)."""
    by_key = {}
    for variant in variants:
        for o in variant:
            by_key.setdefault(o.key, []).append(repr(o.value))
    diff_keys = [k for k, vals in by_key.items() if len(set(vals)) > 1]
    return [" ".join(f"{o.key}={o.value}" for o in variant if o.key in diff_keys) or "(base)"
            for variant in variants]


def choose_run_interactive(variants, logger, input_fn=input) -> int:
    """Picks one sweep variant to run here; returns its run_id, or -1 for
    all."""
    labels = _sweep_diff_labels(variants)
    print("Config expands to multiple runs:")
    for i, label in enumerate(labels):
        print(f"  [{i}] {label}")
    while True:
        raw = input_fn(f"Run which variant? [0-{len(variants) - 1} | all] ").strip().lower()
        if raw in ("all", "a", ""):
            return -1
        try:
            run_id = int(raw)
        except ValueError:
            continue
        if 0 <= run_id < len(variants):
            logger.info("Selected run %d: %s", run_id, labels[run_id])
            return run_id


def _kill(out_dir: str, logger) -> int:
    """Cancels the SLURM jobs that --submit recorded (the record is kept
    unless scancel succeeds) and SIGTERMs the local runs by the exact PIDs
    in their run.pid / run.<rank>.pid files; returns how many it stopped."""
    killed = 0
    job_file = Path(out_dir) / "slurm_job_ids"
    if job_file.exists():
        job_ids = job_file.read_text().split()
        if job_ids and shutil.which("scancel"):
            logger.info("scancel %s", " ".join(job_ids))
            rc = subprocess.call(["scancel"] + job_ids)
            if rc == 0:
                killed += len(job_ids)
                job_file.unlink()
            else:
                logger.error("scancel exited %d; %s keeps the job ids", rc, job_file)
        elif job_ids:
            logger.warning("%s lists SLURM jobs %s but scancel is not on PATH; cancel them "
                           "from a cluster login node", job_file, " ".join(job_ids))
    pid_files = sorted(Path(out_dir).glob("*/run.pid")) + sorted(Path(out_dir).glob("*/run.*.pid"))
    for pid_file in pid_files:
        try:
            pid = int(pid_file.read_text().strip())
            os.kill(pid, signal.SIGTERM)
            logger.info("Sent SIGTERM to %d (%s)", pid, pid_file)
            killed += 1
        except (ValueError, ProcessLookupError, PermissionError) as e:
            logger.info("Skipping %s: %s", pid_file, e)
    logger.info("Killed %d run(s)/job(s)", killed)
    return killed


def _submit(sbatch_path: str, out_dir: str, logger) -> str:
    """`sbatch --parsable`; records the job id for --kill."""
    proc = subprocess.run(["sbatch", "--parsable", sbatch_path], capture_output=True, text=True)
    if proc.returncode != 0:
        logger.error("sbatch failed: %s", proc.stderr.strip())
        raise SystemExit(proc.returncode)
    m = re.match(r"\s*(\d+)", proc.stdout)  # "<id>" or "<id>;<cluster>"
    if m is None:
        raise RuntimeError(f"sbatch printed no job id: {proc.stdout!r}")
    job_id = m.group(1)
    logger.info("Submitted batch job %s", job_id)
    with open(os.path.join(out_dir, "slurm_job_ids"), "a") as f:
        f.write(job_id + "\n")
    return job_id


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-c", "--config-file", required=True)
    parser.add_argument("-r", "--run-id", type=int, default=None,
                        help="run only this sweep variant")
    parser.add_argument("-g", "--debug", action="store_true",
                        help="debug: no data workers")
    parser.add_argument("-l", "--local", action="store_true",
                        help="(default) run here, in this process")
    parser.add_argument("--run-dir", default=None,
                        help="work dir handed to train_net (default OUTPUTS/<expt>/<run_id>)")
    parser.add_argument("--tb", action="store_true",
                        help="launch tensorboard on the experiment outputs")
    parser.add_argument("--delete", action="store_true", help="delete this experiment's outputs")
    parser.add_argument("--kill", action="store_true",
                        help="stop this experiment's runs (recorded SLURM jobs, and the exact "
                             "PIDs in run.pid files)")
    parser.add_argument("--folder", action="store_true",
                        help="serve the experiment outputs over HTTP")
    parser.add_argument("--port", type=int, default=8000, help="port for --folder")
    parser.add_argument("--print-cmd", action="store_true",
                        help="print the command of each host and exit")
    parser.add_argument("--slurm", action="store_true",
                        help="write an sbatch array script (one task per sweep variant, "
                             "requeued on preemption) instead of running")
    parser.add_argument("--sbatch-out", default=None,
                        help="where to write the --slurm script (default <out_dir>/sbatch.sh)")
    parser.add_argument("--submit", action="store_true",
                        help="with --slurm: submit the script and record its job id for --kill")
    parser.add_argument("--spawn", type=int, default=None, metavar="N",
                        help="spawn N local ranks on one rendezvous (N=1: a process group of "
                             "one): N data-parallel replicas, or N/m replicas of m "
                             "tensor-parallel ranks under parallel.model_size=m, which must "
                             "divide N; per-rank logs land in the run dir")
    parser.add_argument("--nodes", type=int, default=None,
                        help="host count for --print-cmd and --slurm; defaults to the "
                             "config's hydra.launcher.nodes")
    parser.add_argument("--master", default="${MASTER_ADDR}:${MASTER_PORT}",
                        help="host:port of rank 0 for multi-host --print-cmd")
    parser.add_argument("extra", nargs="*", help="extra overrides")
    args = parser.parse_args(argv)
    logger = get_logger("avt_tpu_torch.launch")
    out_dir = output_dir_for(args.config_file)

    if args.delete:
        logger.info("Deleting %s", out_dir)
        shutil.rmtree(out_dir, ignore_errors=True)
        return None
    if args.kill:
        return _kill(out_dir, logger)
    if args.folder:
        return subprocess.call([sys.executable, "-m", "http.server", str(args.port),
                                "--directory", out_dir])
    if args.tb:
        return subprocess.call([sys.executable, "-m", "tensorboard.main", "--logdir", out_dir])

    variants = expand_sweeps(parse_overrides_file(args.config_file))
    logger.info("%s expands to %d run(s)", args.config_file, len(variants))
    if (args.run_id is None and len(variants) > 1
            and not (args.print_cmd or args.spawn or args.slurm) and sys.stdin.isatty()):
        picked = choose_run_interactive(variants, logger)
        if picked >= 0:
            args.run_id = picked

    extra = list(args.extra)
    if args.debug:
        extra += ["data_train.workers=0", "data_eval.workers=0"]
    cmd_tail = ["-c", args.config_file] + (["--run-dir", args.run_dir] if args.run_dir else [])
    cmd_tail += extra
    if args.slurm:
        script = emit_sbatch(args, variants, out_dir, cmd_tail)
        sbatch_path = args.sbatch_out or os.path.join(out_dir, "sbatch.sh")
        # the script's --output is under out_dir, which slurmd does not create
        os.makedirs(out_dir, exist_ok=True)
        os.makedirs(os.path.dirname(sbatch_path) or ".", exist_ok=True)
        with open(sbatch_path, "w") as f:
            f.write(script)
        os.chmod(sbatch_path, 0o755)
        print(script)
        if args.submit:
            return _submit(sbatch_path, out_dir, logger)
        logger.info("Wrote %s; submit with: sbatch %s", sbatch_path, sbatch_path)
        return sbatch_path
    if args.run_id is not None:
        cmd_tail += ["--run-id", str(args.run_id)]
    if args.print_cmd:
        # one torchrun a host: it sets the variables setup_distributed reads
        nodes = args.nodes or int(_launcher_param(variants, "nodes", 1))
        gpus = int(_launcher_param(variants, "gpus_per_node", 1))
        check_mesh(variants, extra, nodes * gpus, logger)
        tail = " ".join(shlex.quote(str(el)) for el in cmd_tail)
        if nodes <= 1 and gpus <= 1:
            print(f"{sys.executable} -m {TRAIN_MODULE} {tail}")
            return None
        addr, _, port = args.master.rpartition(":")
        for node in range(nodes):
            print(f"{sys.executable} -m torch.distributed.run --nnodes {nodes} "
                  f"--node-rank {node} --nproc-per-node {gpus} --master-addr {addr} "
                  f"--master-port {port} -m {TRAIN_MODULE} {tail}")
        return None
    if args.spawn:
        check_mesh(variants, extra, args.spawn, logger)
        log_dir = args.run_dir or out_dir
        rcs = []
        for attempt in range(3):
            t0 = time.time()
            rcs, log_paths = _spawn_ranks(args.spawn, cmd_tail, log_dir, logger)
            if not any(rcs):
                return rcs
            if not _bind_failed(log_paths, time.time() - t0):
                break
            logger.warning("the rendezvous port was taken before rank 0 bound it (attempt %d); "
                           "retrying on another", attempt + 1)
        for rank, rc in enumerate(rcs):
            if rc != 0:
                logger.error("rank %d exited %d; see %s", rank, rc, log_paths[rank])
        # a signal's death is a negative code: report the first failure's size
        raise SystemExit(max(abs(rc) for rc in rcs if rc))

    from avt_tpu_torch.train_net import cli as train_cli

    return train_cli(cmd_tail)


if __name__ == "__main__":
    main()
