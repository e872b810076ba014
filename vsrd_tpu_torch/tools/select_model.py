"""Select the best checkpoint by metric constraints.

Counterpart of ``tools/select_model.py``, with its CLI
(``python -m vsrd_tpu_torch.tools.select_model``): scan a directory tree for
``.npz`` checkpoints (the driver's, in the JAX package's layout, read by
``utils/saver.py``), keep those whose stored metrics satisfy every
``name<op>value`` constraint, and copy the best by ``--metric`` to
``model.npz`` in ``--ckpt_dirname``.
"""

import argparse
import glob
import operator
import os
import re
import shutil

from ..utils.saver import load_checkpoint

OPERATORS = {
    "<=": operator.le,
    ">=": operator.ge,
    "<": operator.lt,
    ">": operator.gt,
    "==": operator.eq,
}


def parse_constraint(text):
    match = re.fullmatch(r"([\w/]+)(<=|>=|<|>|==)([-\d.eE]+)", text)
    if not match:
        raise ValueError(f"bad constraint: {text!r}")
    name, op, value = match.groups()
    return name, OPERATORS[op], float(value)


def main(args):
    constraints = [parse_constraint(c) for c in args.constraints]
    candidates = []
    for filename in sorted(
        glob.glob(os.path.join(args.ckpt_dirname, "**", "*.npz"), recursive=True)
    ):
        try:
            checkpoint = load_checkpoint(filename)
        except Exception:  # noqa: BLE001 - as the JAX tool: a file that fails to load is skipped
            continue
        metrics = checkpoint.get("metrics", {})
        values = {k: float(v) for k, v in metrics.items()} if metrics else {}
        if not all(
            name in values and op(values[name], threshold)
            for name, op, threshold in constraints
        ):
            continue
        score = values.get(args.metric)
        if score is None:
            continue
        candidates.append((score, filename))

    if not candidates:
        print("no checkpoint satisfies the constraints")
        return None

    best = max(candidates) if args.maximize else min(candidates)
    target = os.path.join(args.ckpt_dirname, "model.npz")
    shutil.copy(best[1], target)
    print(f"selected {best[1]} ({args.metric}={best[0]:.4f}) -> {target}")
    return best[1]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="vsrd_tpu_torch: checkpoint selector")
    parser.add_argument("--ckpt_dirname", type=str, required=True)
    parser.add_argument("--metric", type=str, default="iou_3d")
    parser.add_argument("--maximize", action="store_true", default=True)
    parser.add_argument("--constraints", type=str, nargs="*", default=[])
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
