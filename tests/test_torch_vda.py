"""Video Depth Anything on the port, against the plain PyTorch reference
in ``tests/_vda_reference.py`` (written from the published model, on its
key layout; it imports neither the port nor JAX, and VDA has no JAX
counterpart): a temporal module at widths 64 and 32, the whole clip
forward, the temporal attention op's plain version, the serving engine's
clip mode on two interleaved streams against VDA's windowing, the
checkpoint conversion, and the benchmark's own reference at the same
size. All on the CPU in float32, on a small geometry (vitt's trunk, T = 8
or one 32-frame window)."""

import importlib
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import _vda_reference as ref

PORT = ("enhanced_3d_reconstruction_in_colonoscopy_using_monocular_depth_"
        "and_pose_estimation_tpu_torch")
da = importlib.import_module(f"{PORT}.models.depth_anything")
convert = importlib.import_module(f"{PORT}.models.convert")
engine_mod = importlib.import_module(f"{PORT}.serving.engine")
tattn = importlib.import_module(f"{PORT}.ops.temporal_attention")
debug = importlib.import_module(f"{PORT}.core.debug")

CFG = ref.TINY
SEED = 7
FRAME_HW = (40, 52)
INPUT_SIZE = 42          # -> a (42, 56) network input, a 3 x 4 patch grid


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    state = ref.random_state(CFG, SEED)
    port = da.build_vda_model("vitt", dtype=torch.float32, device="cpu")
    convert.load_vda_state_dict(port, state)
    return port, ref.VDA(CFG, state), state


def _close(got, want, tol):
    scale = max(float(want.abs().max()), 1e-6)
    assert float((got - want).abs().max()) <= tol * scale


@pytest.mark.parametrize("module,width", [(0, 64), (2, 32)])
def test_temporal_module_matches_reference(models, module, width):
    port, plain, _ = models
    gen = torch.Generator().manual_seed(module)
    x = torch.randn(2 * 8, width, 3, 4, generator=gen)   # two clips of 8
    with torch.no_grad():
        got = port.depth_head.motion_modules[module](x, 8)
    _close(got, plain.temporal(x, module, 8), 1e-5)


def test_vda_forward_matches_reference(models):
    port, plain, _ = models
    gen = torch.Generator().manual_seed(3)
    clip = torch.randn(8, 42, 56, 3, generator=gen)
    with torch.no_grad():
        got = port(clip[None])[0]
        want = plain.clip(clip)
    assert got.shape == (8, 42, 56) and float(got.min()) >= 0
    _close(got, want, 1e-4)


@pytest.mark.parametrize("d", [4, 32])
def test_temporal_attn_plain_matches_reference(d):
    bt, s, h, frames = 2 * 8, 5, 3, 8
    qkv = torch.randn(bt, s, 3, h, d, generator=torch.Generator()
                      .manual_seed(d))
    before = tattn.temporal_attention.launches
    got = tattn.temporal_attention(qkv, frames)
    # VDA's attention: (b f) s h d -> (b s h) f d, softmax over frames.
    q, k, v = (qkv[:, :, i].reshape(bt // frames, frames, s, h, d)
               .permute(0, 2, 3, 1, 4) for i in range(3))
    o = torch.softmax(q @ k.transpose(-1, -2) / d ** 0.5, -1) @ v
    want = o.permute(0, 3, 1, 2, 4).reshape(bt, s, h, d)
    _close(got, want, 1e-6)
    assert tattn.temporal_attention.launches == before   # CPU: no launch
    torch.library.opcheck(tattn._temporal_op, (qkv, frames))


def test_clip_engine_matches_reference_windows(models):
    """Two interleaved streams through the engine's clip mode, map for
    map against VDA's windowing: 50 frames (three windows, 26 positions
    padded over the last two) and 33 (two windows, the second padding
    but for one frame)."""
    port, plain, _ = models
    rng = np.random.default_rng(11)
    coarse = rng.random((8, 5, 7, 3))
    pool = [np.clip(np.kron(c, np.ones((8, 8, 1)))[:40, :52] * 255
                    + rng.integers(0, 30, (40, 52, 3)), 0, 255)
            .astype(np.uint8) for c in coarse]
    streams = {"a": [pool[i % 8] for i in range(50)],
               "b": [pool[(3 * i + 1) % 8] for i in range(33)]}
    since = time.perf_counter_ns()
    with engine_mod.DepthServingEngine(port, input_size=INPUT_SIZE,
                                       device="cpu") as eng:
        futs = {key: [] for key in streams}
        for i in range(50):
            for key, frames in streams.items():
                if i < len(frames):
                    futs[key].append(eng.submit(frames[i], stream=key))
        for key in streams:
            eng.end_stream(key)
        got = {key: [f.result(timeout=120) for f in fs]
               for key, fs in futs.items()}
        assert not eng._streams            # every stream's state freed
        with pytest.raises(ValueError):
            eng.submit(pool[0])
    for key, frames in streams.items():
        want = ref.infer_video(plain, frames, INPUT_SIZE)
        assert len(got[key]) == len(want) == len(frames)
        for g, w in zip(got[key], want):
            assert g.shape == FRAME_HW
            _close(torch.from_numpy(g), torch.from_numpy(w), 2e-4)
    counts = {name: sum(c.n for c in debug.counts(name, since))
              for name in ("clip.windows", "clip.new_frames",
                           "clip.carried_frames", "clip.padded_frames")}
    assert counts == {"clip.windows": 5, "clip.new_frames": 83,
                      "clip.carried_frames": 30, "clip.padded_frames": 47}
    assert len(debug.spans("clip.stitch", since)) == 5


def test_convert_published_layout(models):
    _, _, state = models
    port_sd = convert.vda_state_dict(state)
    c = CFG["out_channels"][2]
    pre = "head.motion_modules.0.temporal_transformer.transformer_blocks.0."
    packed = port_sd["depth_head.motion_modules.0.attention_blocks.1."
                     "to_qkv.weight"]
    assert packed.shape == (3 * c, c)
    assert torch.equal(packed[c:2 * c],
                       state[pre + "attention_blocks.1.to_k.weight"])
    assert torch.equal(port_sd["depth_head.motion_modules.0.ff_out.bias"],
                       state[pre + "ff.net.2.bias"])
    assert not any("pos_encoder" in k or k.startswith("head.")
                   for k in port_sd)
    bad = dict(state)
    bad[pre + "attention_blocks.0.pos_encoder.pe"] = torch.zeros(1, 32, c)
    with pytest.raises(ValueError, match="sinusoidal"):
        convert.vda_state_dict(bad)
    model = da.build_vda_model("vitt", dtype=torch.float32, device="cpu")
    missing = {k: v for k, v in state.items() if "proj_out" not in k}
    with pytest.raises(RuntimeError, match="proj_out"):
        convert.load_vda_state_dict(model, missing)


def test_frame_loader_refuses_a_vda_checkpoint(models, tmp_path):
    """A VDA checkpoint given to a per-frame entry point (``infer``,
    ``serve``, ``video_depth --model dav2``, all through
    ``load_or_init_depth_model``) is refused with a message that names
    the video entry point, before any load."""
    _, _, state = models
    path = tmp_path / "video_depth_anything_vitt.pth"
    torch.save(state, path)
    with pytest.raises(ValueError, match="video_depth --model vda"):
        convert.load_or_init_depth_model("vitt", 20.0, str(path),
                                         device="cpu")


def test_bench_reference_matches_plain(models):
    """The benchmark's ``reference/vda.py`` (built on its DAv2
    reference) equals this one at the small size: the clip forward and
    the windowed, aligned and blended maps of a 40-frame stream."""
    _, plain, state = models
    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    bench = importlib.import_module("h100_bench.reference.vda")
    cfg = {"patch_size": 14, "pos_grid": CFG["pos_grid"],
           "embed_dim": CFG["embed_dim"], "depth": CFG["depth"],
           "num_heads": CFG["heads"], "ffn": "mlp", "ln_eps": 1e-6,
           "intermediate_layer_idx": CFG["taps"],
           "features": CFG["features"],
           "out_channels": CFG["out_channels"],
           "temporal": {"heads": CFG["temporal_heads"]}}
    model = bench.VDA(cfg, state)
    gen = torch.Generator().manual_seed(5)
    clip = torch.randn(8, 42, 56, 3, generator=gen)
    with torch.no_grad():
        _close(model.clip(clip.permute(0, 3, 1, 2)), plain.clip(clip), 1e-5)
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8)
              for _ in range(40)]
    got = model.infer_video(torch.from_numpy(np.stack(frames)), INPUT_SIZE)
    want = ref.infer_video(plain, frames, INPUT_SIZE)
    assert len(got) == len(want) == 40
    for g, w in zip(got, want):
        _close(g, torch.from_numpy(w), 1e-5)
