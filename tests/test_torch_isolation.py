"""The port imports neither JAX nor any module of the JAX package, nor
PyYAML, cv2 or PIL (its own YAML subset, codecs and writers take their
place); ``train_pose --device cpu``, a vitg block, ``pointcloud --device
cpu`` (fusion, the port's own mesher build, the FFT Poisson mesh),
``video_to_images`` with a YAML config, a vitt forward on the speed
dials, ``export_model --check`` and ``nan_checks`` run without them."""

import os
import subprocess
import sys

PORT = ("enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_"
        "and_pose_estimation_tpu_torch")
JAX_PACKAGE = ("enhanced_3d_reconstruction_in_colonoscopy_using_monocular_"
               "depth_and_pose_estimation_tpu")

# Every module of the port; the probe fails if one is missing or leaks.
MODULES = (
    "cli.calc_metrics", "cli.calc_stats", "cli.convert_video",
    "cli.eval_depth_offline", "cli.export_model", "cli.infer",
    "cli.pointcloud",
    "cli.pointcloud_model", "cli.serve", "cli.test_depth",
    "cli.train_depth", "cli.train_pose", "cli.video_depth",
    "cli.video_to_images",
    "core.checkpoint", "core.config", "core.debug", "core.device",
    "core.dtypes", "core.logging", "core.metrics", "core.preempt",
    "core.yamlsubset",
    "data.c3vd", "data.combined", "data.io", "data.loader", "data.native",
    "data.pose", "data.preprocess", "data.simcol", "data.synthetic",
    "evaluation.depth_metrics", "evaluation.pose_metrics", "losses.pose_loss",
    "losses.silog", "media.colormap", "media.imageio", "media.native",
    "media.video", "models.convert", "models.depth_anything",
    "models.dinov2", "models.dpt", "models.resnet_pose", "models.temporal",
    "ops.attention", "ops.augment", "ops.flash_attention", "ops.quant",
    "ops.quaternion", "ops.resize", "ops.temporal_attention",
    "ops.token_merge", "parallel", "parallel.mesh",
    "parallel.pipeline",
    "recon", "recon.native", "recon.ply", "recon.pointcloud",
    "recon.poisson", "recon.stages", "serving.clips", "serving.engine",
    "serving.export",
    "train.depth_task", "train.loop", "train.optim",
    "train.pose_task", "utils.cbuild", "utils.experiment",
)

_PROBE = f"""
import importlib, pkgutil, sys
# Any import of these now raises ImportError: the card's machine need
# not have them.
for name in ("jax", "flax", "yaml", "cv2", "PIL"):
    sys.modules[name] = None
import {PORT} as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, "{PORT}.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(n for n in sys.modules
                if n in ("{JAX_PACKAGE}", "e3d_tpu")
                or n.startswith(("{JAX_PACKAGE}.", "e3d_tpu.")))
print(len(names), leaked)
assert not leaked, leaked
missing = sorted(set("{PORT}." + m for m in {MODULES!r}) - set(names))
assert not missing, missing

# The file paths that replaced cv2, PIL and PyYAML run without them.
import os, tempfile
from {PORT}.core import config
from {PORT}.data import c3vd, simcol, synthetic
with tempfile.TemporaryDirectory() as tmp:
    root = synthetic.make_simcol_fixture(os.path.join(tmp, "s"), 2, 2, 16)
    sample = simcol.SimColDataset(root, os.path.join(root, "train.txt"), 14,
                                  "Train", host_resize=True)[0]
    assert sample["image"].shape == (14, 14, 3), sample["image"].shape
    croot = synthetic.make_c3vd_fixture(os.path.join(tmp, "c"), 1, 2, 16)
    sample = c3vd.C3VDDataset(croot, os.path.join(croot, "train.txt"), 14,
                              "Train")[1]
    assert sample["depth"].shape == (16, 16), sample["depth"].shape
    cfg = config.compose(os.path.join(os.getcwd(), "configs"), "default",
                         ["model=large", "model.encoder_lr=1e-5"])
    config.snapshot(cfg, os.path.join(tmp, "snap"))
    assert cfg.model.encoder_lr == 1e-5

    # Pose training end to end, and one vitg block (SwiGLU, 24 heads).
    import json, torch
    from {PORT}.cli import train_pose
    from {PORT}.models import dinov2
    os.environ["E3D_CONFIG_ROOT"] = os.path.join(os.getcwd(), "configs")
    os.environ["E3D_RESULTS_DIR"] = os.path.join(tmp, "res")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        train_pose.main([f"dataset.data_dir={{root}}",
                         f"dataset.train_list={{root}}/train.txt",
                         f"dataset.val_list={{root}}/val.txt",
                         f"dataset.test_list={{root}}/test.txt",
                         "dataset.batch_size=1", "dataset.num_workers=1",
                         "dataset.size=64", "trainer.max_epochs=1",
                         "++trainer.max_steps=1", "--device", "cpu"])
    finally:
        os.chdir(cwd)
    with open(os.path.join(tmp, "res", "pose_results.json")) as f:
        assert json.load(f)["overall_metrics"]
    arch = dinov2.VIT_ARCHS["vitg"]
    block = dinov2.Block(arch["embed_dim"], arch["num_heads"], arch["ffn"])
    out = block(torch.randn(1, 5, arch["embed_dim"]))
    assert out.shape == (1, 5, 1536) and bool(torch.isfinite(out).all())

    # The speed dials: a vitt forward with int8 and token merging.
    from {PORT}.models import depth_anything
    model = depth_anything.build_depth_model("vitt", device="cpu",
                                             quant_int8=True,
                                             token_merge=0.25)
    with torch.no_grad():
        depth = model(torch.randn(1, 56, 56, 3))
    assert depth.shape == (1, 56, 56) and bool(torch.isfinite(depth).all())

    # Reconstruction: the fixture's depths as predictions, fused and
    # meshed on the CPU; frames of an AVI through a YAML config.
    import glob, shutil
    import numpy as np
    from {PORT}.cli import pointcloud, video_to_images
    from {PORT}.media import native as media_native
    from {PORT}.recon import read_ply
    rroot = synthetic.make_simcol_fixture(os.path.join(tmp, "r"), 1, 3, 32)
    for d in glob.glob(os.path.join(rroot, "SyntheticColon_I", "Frames_S*",
                                    "Depth_*.png")):
        op = os.path.dirname(d) + "_OP"
        os.makedirs(op, exist_ok=True)
        shutil.copy(d, os.path.join(op, os.path.basename(d)))
    res = pointcloud.main(["-i", rroot, "-o", os.path.join(tmp, "pc"),
                           "--mesh-depth", "5", "--voxel-size", "0.005",
                           "--device", "cpu"])
    mesh = read_ply(os.path.join(tmp, "pc", "combined_mesh.ply"))
    assert res["frames"] == 3 and len(mesh["points"]) == res["verts"] > 0
    avi = os.path.join(tmp, "v.avi")
    with media_native.VideoWriter(avi, 32, 16, fps=10.0) as w:
        for i in range(3):
            w.write_rgb(np.full((16, 32, 3), 40 * i, np.uint8))
    cfg = os.path.join(tmp, "v.yaml")
    with open(cfg, "w") as f:
        f.write(f"video_path: {{avi}}\\noutput_dir: {{tmp}}/frames\\n"
                "fps: null\\nstart_time: 0.0\\nend_time: null\\n")
    assert video_to_images.main(["--config", cfg]) == 3

    # Export and replay (torch.export, the kernel ops), and a NaN check.
    from {PORT}.cli import export_model
    from {PORT}.core.debug import nan_checks
    meta = export_model.main(["--device", "cpu", "--encoder", "vitt",
                              "--frame-hw", "56", "56", "--batch-size", "1",
                              "--input-size", "56", "--check",
                              "-o", os.path.join(tmp, "p.pt2")])
    assert meta["check_max_abs"] == 0.0
    with nan_checks():
        try:
            torch.tensor([float("nan")]) * 2
            raise AssertionError("nan_checks let a NaN through")
        except FloatingPointError:
            pass
"""


def test_port_imports_without_jax_or_the_jax_package():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
