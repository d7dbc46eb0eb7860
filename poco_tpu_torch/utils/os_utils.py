"""Reproducibility helper: a snapshot of the code into the logdir (port of
`poco_tpu.utils.os_utils`; reference pocolib/utils/os_utils.py:9-31).
"""

from __future__ import annotations

import os
import os.path as osp
import shutil

# what a run's code is: the package (its CLIs are its entry points) and the
# card's smoke script beside it
CODE_ITEMS = ("poco_tpu_torch", "chip_smoke.py")


def project_root() -> str:
    return osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))


def copy_code(output_folder: str, curr_folder: str | None = None,
              code_folder: str = "code") -> str:
    """Copy the port's sources into `<output_folder>/<code_folder>` and
    return that path: the package without its built libraries (`_build/`)
    or caches, and the entry files that exist."""
    curr_folder = curr_folder or project_root()
    dst = osp.join(output_folder, code_folder)
    os.makedirs(dst, exist_ok=True)
    for item in CODE_ITEMS:
        src = osp.join(curr_folder, item)
        if not osp.exists(src):
            continue
        target = osp.join(dst, item)
        if osp.isdir(src):
            shutil.copytree(src, target, dirs_exist_ok=True,
                            ignore=shutil.ignore_patterns("__pycache__", "_build"))
        else:
            shutil.copy2(src, target)
    return dst
