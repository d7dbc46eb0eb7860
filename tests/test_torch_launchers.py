"""PyTorch port vs JAX package: the grid-search launchers
(`poco_tpu_torch/utils/cluster.py`) and `--make_launcher` of `cli.train`
and `cli.eval`.

The launchers' text equals the JAX package's (`poco_tpu.utils.cluster`)
line for line, apart from the command (`python -m
poco_tpu_torch.cli.train` / `.cli.eval` for `python train.py` /
`eval.py`); `bash -n` parses each; the grid counts agree.
"""

import os
import shutil
import subprocess

import pytest

from poco_tpu.utils import cluster as jax_cluster

from poco_tpu_torch.cli import eval as eval_cli
from poco_tpu_torch.cli import train as train_cli
from poco_tpu_torch.utils import cluster

from .test_torch_model import REPO

GRID = str(REPO / "tests" / "data" / "tiny_smoke_grid.yaml")
TINY = str(REPO / "configs" / "tiny_smoke.yaml")
COMMANDS = {cluster.TRAIN: "train.py", cluster.EVAL: "eval.py"}


def _as_jax(text: str, module: str) -> str:
    return text.replace(f"python -m {module} ", f"python {COMMANDS[module]} ")


def _bash_parses(path: str) -> None:
    proc = subprocess.run([shutil.which("bash") or "/bin/bash", "-n", path],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("cfg,n", [(GRID, 2), (TINY, 1)])
def test_num_experiments_matches_jax(cfg, n):
    assert cluster.num_experiments(cfg) == jax_cluster.num_experiments(cfg) == n


@pytest.mark.parametrize("module", [cluster.TRAIN, cluster.EVAL])
@pytest.mark.parametrize("scheduler,constraint", [("bash", ""), ("slurm", ""),
                                                  ("slurm", "v5e-8")])
def test_launcher_matches_jax(tmp_path, module, scheduler, constraint):
    path = cluster.write_launcher(GRID, str(tmp_path / "port"), module=module,
                                  scheduler=scheduler, constraint=constraint)
    want = jax_cluster.write_launcher(GRID, str(tmp_path / "jax"), script=COMMANDS[module],
                                      scheduler=scheduler, tpu_topology=constraint)
    assert os.path.basename(path) == os.path.basename(want)
    with open(path) as f, open(want) as g:
        text = f.read()
        assert _as_jax(text, module) == g.read()
    assert f"python -m {module} --cfg {GRID} --cfg_id" in text
    assert os.access(path, os.X_OK)
    _bash_parses(path)


def test_multihost_launcher_matches_jax(tmp_path):
    path = cluster.write_multihost_launcher(GRID, 4, str(tmp_path / "port"))
    want = jax_cluster.write_multihost_launcher(GRID, 4, str(tmp_path / "jax"))
    with open(path) as f, open(want) as g:
        assert _as_jax(f.read(), cluster.TRAIN) == g.read()
    _bash_parses(path)
    with pytest.raises(ValueError, match="bash or slurm"):
        cluster.write_launcher(GRID, str(tmp_path), scheduler="condor")


@pytest.mark.parametrize("cli,module", [(train_cli, cluster.TRAIN), (eval_cli, cluster.EVAL)])
def test_cli_make_launcher_writes_and_exits(monkeypatch, tmp_path, capsys, cli, module):
    monkeypatch.chdir(tmp_path)
    out = cli.main(["--cfg", GRID, "--make_launcher", "slurm"])
    assert out == {"launcher": os.path.join("scripts", "tiny_smoke_grid.sbatch")}
    text = (tmp_path / "scripts" / "tiny_smoke_grid.sbatch").read_text()
    assert "#SBATCH --array=0-1" in text and f"python -m {module} " in text
    assert "launcher written" in capsys.readouterr().out
    assert not (tmp_path / "logs").exists()   # nothing trained or evaluated
