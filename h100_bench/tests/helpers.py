"""A tiny serving cell the CPU tests drive through the harness."""

import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# The port's ``vitt`` debug encoder (4 blocks, 64 wide, pos-embed grid 4).
TINY_CONFIG = dict(
    name="tiny", encoder="vitt", patch_size=14, pos_grid=4, embed_dim=64,
    depth=4, num_heads=2, head_dim=32, ffn="mlp", mlp_hidden=256,
    ln_eps=1e-6, intermediate_layer_idx=[0, 1, 2, 3], features=32,
    out_channels=[16, 32, 48, 64], max_depth=20.0, dtype="bfloat16")


def tiny_spec(generator: str = "closed_loop", **traffic) -> dict:
    """A cell of the tiny model at 61 x 75 frames, 56 px, batch 4, with
    vitl-serve-backlog's limits and the serving metrics."""
    with open(ROOT / "BENCHMARK.json", encoding="utf-8") as f:
        manifest = json.load(f)
    with open(BENCH / "limits" / "vitl-serve-backlog.json",
              encoding="utf-8") as f:
        limits = json.load(f)
    base = dict(generator=generator, in_flight=8, scopes=2, fps=30,
                frame_hw=[61, 75], pool=16, input_size=56, batch_size=4,
                max_delay_ms=20, warmup_batches=1, trace_slice_s=0.3,
                check_frames=8, grace_s=5)
    base.update(traffic)
    like = ("vitl-serve-backlog" if generator == "closed_loop"
            else "vitl-live-scopes")
    return dict(cell=dict(name="tiny", chips=1), config=TINY_CONFIG,
                traffic=base, limits={**limits, "checked_frames_min": 8},
                **_metrics(manifest, like))


def _metrics(manifest: dict, cell: str) -> dict:
    """The metrics ``cell`` reports."""
    return {key: [m for m in manifest[key]
                  if cell in m.get("workloads", [cell])]
            for key in ("end_to_end", "per_layer")}


def tiny_train_spec(**overrides) -> dict:
    """vitl-finetune's traffic and limits on the tiny model: 61 x 75
    frames at 56 px, microbatch 2, two microbatches a step."""
    with open(ROOT / "BENCHMARK.json", encoding="utf-8") as f:
        manifest = json.load(f)
    with open(BENCH / "traffic" / "finetune.json", encoding="utf-8") as f:
        traffic = json.load(f)
    with open(BENCH / "limits" / "vitl-finetune.json", encoding="utf-8") as f:
        limits = json.load(f)
    traffic.update(microbatch=2, accumulate=2, frame_hw=[61, 75],
                   input_size=56, ref_chunk=1)
    config = {**TINY_CONFIG, **overrides}
    return dict(cell=dict(name="tiny-train", chips=1), config=config,
                traffic=traffic, limits=limits,
                **_metrics(manifest, "vitl-finetune"))
