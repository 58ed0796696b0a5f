"""The readings that a cell's limits are set from (never run by a benchmark
run): the compared numbers of the program over many seeds, of the control
(the plain reference in bfloat16, put in the program's place) and, for a
train cell, of the planted faults, all at the cell's own size, in one
process:

    python3 -m portbench.calibrate --workload scene2.render --seeds 101-112 \\
        --control 101-103 --seconds 2 --out readings/scene2_render.jsonl

One JSON line per seed and variant goes to --out; the last line of
standard output gives, per number, the lower reading (the largest of the
program's) and the upper (the smallest of the control's and the faults').
A frames cell runs a short window per seed, as a run does, and compares as
many frames; a train cell needs no window: its numbers are its first steps.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

import torch

from portbench import faults, harness
from portbench.kinds import adam_steps


def seeds_of(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        if "-" in part:
            a, b = part.split("-")
            out += list(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def frames_readings(cell, seed, seconds, control, device):
    Load = harness.load_kind(cell.traffic["kind"])
    load = Load(cell.config, cell.traffic, seed, device)
    load.setup()
    load.window(harness.Window(seconds))
    load.release()
    _free()
    rows = [("program", load.check())]
    if control:
        rows.append(("control_bf16", load.check(frames=load.control_frames(torch.bfloat16))))
    return rows


def train_readings(cell, seed, control, planted, device):
    Load = harness.load_kind(cell.traffic["kind"])

    def program(**fault):
        load = Load(cell.config, cell.traffic, seed, device)
        load.setup(**fault)
        load.release()
        _free()
        return load

    load = program()
    ref = load.follow()
    rows = [("program", load.check(ref=ref))]
    if control:
        ctrl = load.follow(torch.bfloat16)
        rows.append(("control_bf16", adam_steps.compare(ctrl, ref, load.fields)))
    if planted:
        half = program(spp_fault=max(cell.traffic["spp"] // 2, 1))
        rows.append(("fault_half_batch", half.check(ref=ref)))
        rows.append(("fault_halved_gradients",
                     program(optimizer_fault=faults.halved_gradients).check(ref=ref)))
        rows.append(("fault_frozen_state",
                     program(optimizer_fault=faults.frozen_state).check(ref=ref)))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="e.g. 101-112 or 5,9,13")
    p.add_argument("--control", default="", help="seeds that also run the control")
    p.add_argument("--faults", default="", help="seeds that also run the planted faults")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = harness.find_cell(pathlib.Path.cwd(), args.workload)
    control, planted = set(seeds_of(args.control)), set(seeds_of(args.faults))
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    lower, upper = {}, {}
    with open(out, "a") as f:
        for seed in seeds_of(args.seeds):
            t0 = time.perf_counter()
            if cell.traffic["kind"] == "adam_steps":
                rows = train_readings(cell, seed, seed in control, seed in planted, device)
            else:
                rows = frames_readings(cell, seed, args.seconds, seed in control, device)
            for variant, numbers in rows:
                line = {"workload": cell.name, "seed": seed, "variant": variant,
                        "numbers": numbers, "seconds": time.perf_counter() - t0}
                f.write(json.dumps(line) + "\n")
                f.flush()
                print(json.dumps(line), flush=True)
                for k, v in numbers.items():
                    if variant == "program":
                        lower[k] = max(lower.get(k, 0.0), v)
                    else:
                        upper.setdefault(k, {})[variant] = min(upper.get(k, {}).get(variant, v), v)
            _free()
    print(json.dumps({"workload": cell.name, "lower": lower, "upper": upper,
                      "card": torch.cuda.get_device_name(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
