"""Config-tree refactoring CLI: factor shared keys up (gather) or push
them back down (scatter) a directory tree of config.json files.

Counterpart of ``vsrd_tpu/configuration/configure.py``, over the port's
``configurator.py``: the tree is snapshotted first and restored if the
rewrite raises, so a failed refactor never leaves a half-edited config tree.

    python -m vsrd_tpu_torch.configuration.configure configs/kitti_360 --gather
    python -m vsrd_tpu_torch.configuration.configure configs/kitti_360 --scatter
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

from .configurator import Configurator


def run(root: str, gather: bool = False, scatter: bool = False,
        verbose: bool = False) -> bool:
    """Apply gather/scatter under a snapshot; returns True on success."""
    backup = tempfile.mkdtemp(prefix="configure_backup_")
    snapshot = os.path.join(backup, os.path.basename(os.path.normpath(root)))
    shutil.copytree(root, snapshot)
    try:
        if gather:
            Configurator.gather(root, verbose=verbose)
        if scatter:
            Configurator.scatter(root, verbose=verbose)
    except Exception as error:  # noqa: BLE001 - restore on any failure, and report it
        print(f"{type(error).__name__}: {error} - restoring the config tree")
        shutil.rmtree(root)
        shutil.move(snapshot, root)
        shutil.rmtree(backup, ignore_errors=True)
        return False
    shutil.rmtree(backup)
    return True


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="JSON Configurator")
    parser.add_argument("root", type=str)
    parser.add_argument("--gather", action="store_true")
    parser.add_argument("--scatter", action="store_true")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)
    ok = run(args.root, gather=args.gather, scatter=args.scatter, verbose=args.verbose)
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
