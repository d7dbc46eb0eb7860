"""Cluster launchers: grid-search array jobs as shell scripts (port of
`poco_tpu.utils.cluster`).

The reference submits HTCondor array jobs, one a grid-search experiment,
each running `train.py --cfg_id $Process` (pocolib/utils/cluster.py:
28-82). As in the JAX package, the launcher is a portable script (a bash
loop or a SLURM array file) with the same contract: N experiments from
one YAML, one process a cfg_id, here `python -m poco_tpu_torch.cli.train`
(or `.cli.eval`). `write_multihost_launcher` exports the POCO_* variables
that `parallel/distributed.py` reads to form one process group over hosts.
"""

from __future__ import annotations

import os
import stat

import yaml

TRAIN = "poco_tpu_torch.cli.train"
EVAL = "poco_tpu_torch.cli.eval"


def num_experiments(cfg_file: str) -> int:
    from ..config import get_grid_search_configs

    with open(cfg_file) as f:
        cfg = yaml.safe_load(f)
    experiments, _ = get_grid_search_configs(cfg)
    return len(experiments)


def _write(path: str, body: str) -> str:
    with open(path, "w") as f:
        f.write(body)
    os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR)
    return path


def write_launcher(cfg_file: str, out_dir: str = "scripts", module: str = TRAIN,
                   scheduler: str = "bash", constraint: str = "") -> str:
    """Write a launcher running every grid-search experiment of `cfg_file`
    through `python -m <module>`; returns its path.

    Args:
        scheduler: "bash" (a sequential local loop, `<name>.sh`) or "slurm"
            (an array job, `<name>.sbatch`).
        constraint: the SLURM `--constraint` line's value (the JAX
            package's `tpu_topology`), none when empty.
    """
    if scheduler not in ("bash", "slurm"):
        raise ValueError(f"scheduler {scheduler!r}: bash or slurm")
    n = num_experiments(cfg_file)
    os.makedirs(out_dir, exist_ok=True)
    name = os.path.splitext(os.path.basename(cfg_file))[0]
    if scheduler == "slurm":
        return _write(os.path.join(out_dir, f"{name}.sbatch"), (
            "#!/bin/bash\n"
            f"#SBATCH --array=0-{n - 1}\n"
            f"#SBATCH --job-name={name}\n"
            + (f"#SBATCH --constraint={constraint}\n" if constraint else "")
            + f"python -m {module} --cfg {cfg_file} --cfg_id $SLURM_ARRAY_TASK_ID\n"
        ))
    return _write(os.path.join(out_dir, f"{name}.sh"), (
        "#!/bin/bash\nset -e\n"
        f"for i in $(seq 0 {n - 1}); do\n"
        f"  python -m {module} --cfg {cfg_file} --cfg_id $i\n"
        "done\n"
    ))


def write_multihost_launcher(cfg_file: str, num_hosts: int, out_dir: str = "scripts",
                             module: str = TRAIN, coordinator_port: int = 7701) -> str:
    """Write the multi-host launcher: one process a host, all in one
    process group. Run it on every host as `./<name>.multihost.sh <i>
    <host0-hostname>`, i = 0..N-1; host 0 is the coordinator."""
    os.makedirs(out_dir, exist_ok=True)
    name = os.path.splitext(os.path.basename(cfg_file))[0]
    path = os.path.join(out_dir, f"{name}.multihost.sh")
    return _write(path, (
        "#!/bin/bash\n"
        "# usage (on EVERY host, i = 0..N-1): "
        f"./{os.path.basename(path)} <i> <host0-hostname>\n"
        "set -e\n"
        'PROC_ID="${1:?process id (0..'
        f"{num_hosts - 1}"
        ')}"\n'
        'COORD_HOST="${2:?coordinator hostname (host 0)}"\n'
        f'export POCO_COORDINATOR="$COORD_HOST:{coordinator_port}"\n'
        f"export POCO_NUM_PROCESSES={num_hosts}\n"
        'export POCO_PROCESS_ID="$PROC_ID"\n'
        f"python -m {module} --cfg {cfg_file}\n"
    ))
