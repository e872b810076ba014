"""Readings for the limits of the comparison that decides ``correct``, on the
card at a cell's own size (the benchmark's runs never run this)::

    python3 benchmark/control.py --workload b8-f1 --seeds 11 12 13 \\
        --control-seeds 11 12 13 --fault-seeds 11 12 13

For each seed it runs the cell's set-up (the scenes, the parameters, the
checked steps of each phase through ``optimize_chunk``) and the plain
reference, and prints one JSON line of the numbers that ``check.py`` makes:

* ``sound``: the program as the configuration states it;
* ``control``: the reference computed with the residual MLP's products in
  float8 (e4m3) operands, each scaled per tensor onto float8's range first
  as an fp8 kernel would run them, one precision below the configuration's
  bf16, put in the program's place (its field at the program's points with
  the program's cotangents, beside its steps);
* ``half_batch``: the program with half of each step's rays left out (the
  ray draw returns its first half), the means taken over the rest; its
  field numbers are left out (its kernels are the sound ones, so they read
  as the sound run's at its own points).

A state left unchanged reads 1 on ``change`` by its definition and needs no
run. The last line sums up: the largest sound reading and the smallest
control and fault readings of each number.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import check, run  # noqa: E402


@contextlib.contextmanager
def half_batch(opt):
    """The ray draw of every step returns half of its rays."""
    draw = opt.sampling.multinomial_logits

    def half(logits, num_samples, generator=None):
        return draw(logits, num_samples, generator)[..., :num_samples // 2]

    opt.sampling.multinomial_logits = half
    try:
        yield
    finally:
        opt.sampling.multinomial_logits = draw


@contextlib.contextmanager
def unchanged_state(opt):
    """Every Adam step leaves the parameters and the state as they are."""
    step = opt.Adam.step
    opt.Adam.step = lambda self, params, grads, state: None
    try:
        yield
    finally:
        opt.Adam.step = step


FAULTS = {"half_batch": half_batch, "unchanged_state": unchanged_state}


def numbers_of(records, followed) -> dict:
    """Every candidate reading (``check.phase_readings``), the larger of
    the two phases'."""
    phases = [check.phase_readings(records[name], followed[name]) for name in run.PHASES]
    keys = dict.fromkeys(k for p in phases for k in p)
    return {k: max(p[k] for p in phases if k in p) for k in keys}


def read_seed(workload, seed, device, sizes, control: bool, faults) -> dict:
    """The numbers of one seed: sound, and the control's and faults' when asked."""
    import torch
    from vsrd_tpu_torch.pipeline import optimize as opt
    out = {"seed": seed}
    begin = time.perf_counter()
    c = run.prepare(workload, seed, device, sizes)
    run.free_program(c)
    out["setup_s"] = time.perf_counter() - begin
    begin = time.perf_counter()
    followed = run.follow_reference(c)
    out["reference_s"] = time.perf_counter() - begin
    out["sound"] = numbers_of(c.records, followed)
    if control:
        from benchmark import reference
        lower = run.follow_reference(c, products=reference.lower_precision(torch.float8_e4m3fn))
        out["control"] = numbers_of(lower, followed)
    for name in faults:
        with FAULTS[name](opt):
            faulty = run.prepare(workload, seed, device, sizes)
        run.free_program(faulty)
        for record in faulty.records.values():
            record.pop("field", None)
        out[name] = numbers_of(faulty.records, followed)
    return out


def summary(lines) -> dict:
    keys = lines[0]["sound"]
    out = {"sound_max": {k: max(line["sound"][k] for line in lines) for k in keys}}
    for kind in ("control", *FAULTS):
        read = [line[kind] for line in lines if kind in line]
        if read:
            out[f"{kind}_min"] = {k: min(r[k] for r in read if k in r) for k in keys
                                  if any(k in r for r in read)}
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--faults", nargs="*", default=["half_batch"])
    args = parser.parse_args(argv)
    run.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: these readings are the card's")
    print(f"card: {run.card_label()}", file=sys.stderr, flush=True)
    lines = []
    for seed in args.seeds:
        line = read_seed(args.workload, seed, "cuda", None, seed in args.control_seeds,
                         args.faults if seed in args.fault_seeds else [])
        lines.append(line)
        print(json.dumps({"workload": args.workload, **line}), flush=True)
    print(json.dumps({"workload": args.workload, "summary": summary(lines)}), flush=True)


if __name__ == "__main__":
    main()
