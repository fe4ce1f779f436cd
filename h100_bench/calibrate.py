"""Readings for a cell's limits: the program's, the control's, faults'.

    python3 h100_bench/calibrate.py --workload vitl-serve-backlog \
        --seeds 101 102 ... --control-seeds 101 102 103 --seconds 5
    python3 h100_bench/calibrate.py --workload vitl-finetune \
        --seeds 101 ... --control-seeds 101 ... --control-steps 1 \
        --faults half ahead --fault-seeds 101 102 103 --seconds 0.1

For each of ``--seeds`` it runs the cell as ``run.py`` does, at the cell's
own load for a short window, and prints the numbers the check compared.
For each of ``--control-seeds`` it puts the control in the program's
place: the reference computed with every product's operands rounded to
float8 e4m3 (one step below the served and trained bf16), over the
frames or steps a run of that seed checks (a training cell's first
``--control-steps``), and prints the same numbers against the float32
reference. A training cell's ``--faults`` (``planted``) run the program
broken underneath on ``--fault-seeds``, each held to the reference that
seed's sound run took; ``--reference-steps`` has that reference follow
only the first steps (the numbers of the first step read the same; a
number of later steps then reads as missing, and ``correct`` as false).
A limit lies between the program's largest reading and the control's or
a fault's smallest (``limits/<workload>.json``). The benchmark's own runs
never run this. Each reading is one JSON line on standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_reading(spec: dict, seed: int, device: str = "cuda") -> dict:
    """The control's ``map_rel_err`` against the float32 reference, over
    as many frames of the seed's pool as a run checks."""
    import numpy as np
    import torch

    from h100_bench import loadgen, serving
    from h100_bench.reference.dav2 import DAv2
    from h100_bench.weights import make_weights

    cfg, traffic = spec["config"], spec["traffic"]
    frames = loadgen.make_frames(seed, int(traffic["pool"]),
                                 tuple(traffic["frame_hw"]), device)
    rng = np.random.default_rng(int(seed) % (1 << 63))
    pick = rng.choice(len(frames), int(traffic["check_frames"]),
                      replace=len(frames) < int(traffic["check_frames"]))
    state = make_weights(cfg, seed, device)
    ref, ctl = DAv2(cfg, state), DAv2(cfg, state, fp8=True)
    block = int(traffic["batch_size"])
    maes, spreads = [], []
    for i in range(0, len(pick), block):
        x = torch.from_numpy(np.stack([frames[j] for j in pick[i:i + block]])
                             ).to(device)
        size = int(traffic["input_size"])
        want = ref.depth_of_frames(x, size)
        maes += (ctl.depth_of_frames(x, size) - want).abs().mean(
            dim=(1, 2)).tolist()
        spreads += (want - want.mean(dim=(1, 2), keepdim=True)
                    ).abs().mean(dim=(1, 2)).tolist()
    return {"map_rel_err": serving.relative_error(maes, spreads),
            **_details(maes, spreads), "checked_frames": len(pick)}


def _details(maes: list, spreads: list) -> dict:
    """The worst map's error in metres and over its own deviation."""
    import numpy as np

    m, s = np.asarray(maes), np.asarray(spreads)
    return {"worst_mae_m": float(m.max()),
            "worst_rel": float((m / s).max())}


def train_control_reading(spec: dict, seed: int, device: str = "cuda",
                          steps: int | None = None,
                          reference: dict | None = None,
                          run=None) -> dict:
    """The control's training numbers against the float32 reference over
    the first ``steps`` set-up steps of ``seed`` (all by default); the
    reference's readings and the seed's ``Run`` are taken where not
    given."""
    from h100_bench import harness, training

    if run is None:
        tr = spec["traffic"]
        run = harness.Run(spec, device, 0.0, None,
                          (int(tr["input_size"]),) * 2)
        images, depths = training.training_data(spec, seed, device)
        run.extra.update(images=images, depths=depths,
                         rows=int(tr["accumulate"]) * int(tr["microbatch"]))
    ref = (training.reference_readings(run, seed) if reference is None
           else reference)
    ctl = training.reference_readings(run, seed, fp8=True, steps=steps)
    return {**training.training_numbers(ctl, ref), "losses": ctl["loss"],
            "reference_losses": ref["loss"],
            "leaves": {"control": ctl["grad_norms"],
                       "reference": ref["grad_norms"]}}


def _scaled(schedules, kind: str):
    """The groups' schedules under an optimizer fault."""
    enc, dec = schedules
    return {"lr_x10": (lambda s: 10 * enc(s), lambda s: 10 * dec(s)),
            "swapped": (dec, enc),
            "ahead": (lambda s: enc(s + 1), lambda s: dec(s + 1))}[kind]


@contextlib.contextmanager
def planted(fault: str):
    """A training step broken underneath the harness:

    - ``unchanged``: the step returns its state untouched;
    - ``half``: each microbatch loses its second half, the loss and
      gradients taken as the mean over the rest;
    - ``lr_x10``, ``swapped``, ``ahead``: the optimizer steps with ten
      times each group's learning rate, with the two groups' schedules
      swapped, or one step ahead of its schedule."""
    if not fault:
        yield
        return
    import importlib

    import torch

    from h100_bench import harness

    task_cls = importlib.import_module(
        f"{harness.PORT}.train.depth_task").DepthTask
    step, init = task_cls.train_step, task_cls.init_state

    def unchanged(self, state, batch):
        return state, {"loss": torch.tensor(1.0)}

    def half(self, state, batch):
        mb = batch["image"].shape[1]
        return step(self, state, {k: v[:, :mb // 2] for k, v in batch.items()})

    def init_state(self, *args, **kwargs):
        state = init(self, *args, **kwargs)
        state.optimizer.schedules = _scaled(state.optimizer.schedules, fault)
        return state

    if fault in ("unchanged", "half"):
        task_cls.train_step = {"unchanged": unchanged, "half": half}[fault]
    else:
        task_cls.init_state = init_state
    try:
        yield
    finally:
        task_cls.train_step, task_cls.init_state = step, init


FAULTS = ("unchanged", "half", "lr_x10", "swapped", "ahead")


def _train_line(side: str, seed: int, ok: bool, checks: dict, run,
                t: float) -> str:
    return json.dumps({
        "side": side, "seed": seed, "correct": ok, "checks": checks,
        **run.extra["numbers"],
        "leaves": {"program": run.extra["program"]["grad_norms"],
                   "reference": run.extra["reference"]["grad_norms"]},
        "seconds": time.perf_counter() - t})


def calibrate_training(spec: dict, args, device: str = "cuda") -> None:
    """The program's readings on ``args.seeds``, each seed's faults and
    control against the reference its sound run took."""
    from h100_bench import harness, training

    for seed in args.seeds:
        t = time.perf_counter()
        run = training.window(spec, seed, args.seconds, False, device, t)
        ref = (None if args.reference_steps is None else
               training.reference_readings(run, seed,
                                           steps=args.reference_steps))
        ok, checks = training.check(run, seed, reference=ref)
        print(_train_line("program", seed, ok, checks, run, t), flush=True)
        ref = run.extra["reference"]
        for fault in (args.faults if seed in args.fault_seeds else ()):
            t = time.perf_counter()
            with planted(fault):
                bad = training.window(spec, seed, args.seconds, False,
                                      device, t)
            ok, checks = training.check(bad, seed, reference=ref)
            print(_train_line(fault, seed, ok, checks, bad, t), flush=True)
            del bad
        if seed in args.control_seeds:
            t = time.perf_counter()
            reading = train_control_reading(spec, seed, device,
                                            args.control_steps, ref, run)
            print(json.dumps({"side": "control", "seed": seed, **reading,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
        del run, ref
        harness.free(device)
    for seed in (s for s in args.control_seeds if s not in args.seeds):
        t = time.perf_counter()
        reading = train_control_reading(spec, seed, device,
                                        args.control_steps)
        print(json.dumps({"side": "control", "seed": seed, **reading,
                          "seconds": time.perf_counter() - t}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-steps", type=int, default=None)
    p.add_argument("--reference-steps", type=int, default=None)
    p.add_argument("--faults", nargs="*", choices=FAULTS, default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from h100_bench import harness

    spec = harness.cell_spec(args.workload)
    if spec["traffic"]["generator"] == "train_steps":
        calibrate_training(spec, args)
        return 0
    for seed in args.seeds:
        t = time.perf_counter()
        out = harness.run_cell(spec, seed, args.seconds, False)
        run = out["_run"]
        print(json.dumps({"side": "program", "seed": seed,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"],
                          **_details(run.extra["map_mae"],
                                     run.extra["map_spread"]),
                          "seconds": time.perf_counter() - t}), flush=True)
    for seed in args.control_seeds:
        t = time.perf_counter()
        print(json.dumps({"side": "control", "seed": seed,
                          **control_reading(spec, seed),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
