"""Operations and bytes of the work a cell asks for, from the shapes of
its configuration alone, and the card's published peaks.

Nothing here reads the program: a count is what the mathematics needs at
the configuration's sizes, so a later change of the program cannot move
the yardstick it is measured by.

- ``forward_flops``: multiply-adds x 2 of one frame's DAv2 forward at a
  network input size: the patch conv, every block's projections, MLP or
  SwiGLU and attention products, and the DPT head's convolutions (each
  fusion block's 1x1 conv counted at its input's size). Norms,
  activations, softmax and the resizes are left out: they are bound by
  bytes and small beside the products.
- ``attn_fwd_work`` / ``attn_bwd_work``: flash attention over (B, N, H, D)
  in bf16: 4 B H N^2 D operations forward, 2.5 times that backward; bytes
  are each input read once and each output written once (q, k, v, o and
  the f32 log-sum-exp forward; q, k, v, o, dO, dq, dk, dv and the
  log-sum-exp backward).
- ``resize_work``: an align-corners bilinear resize of (B, C, h, w) to
  (h2, w2): its input read and its output written once.
- ``dpt_resizes``: the five align-corners resizes of the DPT head.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core FLOP/s, HBM3 bytes/s.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16_BYTES = 2
F32_BYTES = 4


def grid(cfg: dict, net_hw: tuple[int, int]) -> tuple[int, int]:
    ps = cfg["patch_size"]
    return net_hw[0] // ps, net_hw[1] // ps


def tokens(cfg: dict, net_hw: tuple[int, int]) -> int:
    gh, gw = grid(cfg, net_hw)
    return gh * gw + 1


def encoder_flops(cfg: dict, net_hw: tuple[int, int]) -> float:
    c, hid = cfg["embed_dim"], cfg["mlp_hidden"]
    gh, gw = grid(cfg, net_hw)
    n = tokens(cfg, net_hw)
    patch = 2.0 * gh * gw * c * 3 * cfg["patch_size"] ** 2
    qkv = 2.0 * n * c * 3 * c
    proj = 2.0 * n * c * c
    attn = 4.0 * n * n * c
    if cfg["ffn"] == "swiglu":
        ffn = 2.0 * n * c * 2 * hid + 2.0 * n * hid * c
    else:
        ffn = 2.0 * n * c * hid * 2
    return patch + cfg["depth"] * (qkv + proj + attn + ffn)


def _conv(h: int, w: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * h * w * cin * cout * k * k


def decoder_sizes(cfg: dict, net_hw: tuple[int, int]
                  ) -> list[tuple[int, int]]:
    """The four scratch levels' sizes, finest first."""
    ph, pw = grid(cfg, net_hw)
    return [(4 * ph, 4 * pw), (2 * ph, 2 * pw), (ph, pw),
            ((ph - 1) // 2 + 1, (pw - 1) // 2 + 1)]


def decoder_flops(cfg: dict, net_hw: tuple[int, int]) -> float:
    c, f, oc = cfg["embed_dim"], cfg["features"], cfg["out_channels"]
    ph, pw = grid(cfg, net_hw)
    sizes = decoder_sizes(cfg, net_hw)
    total = sum(_conv(ph, pw, c, o, 1) for o in oc)            # projects
    total += 2.0 * ph * pw * oc[0] * oc[0] * 16                 # 4x conv-T
    total += 2.0 * ph * pw * oc[1] * oc[1] * 4                  # 2x conv-T
    total += _conv(*sizes[3], oc[3], oc[3], 3)                  # stride 2
    total += sum(_conv(*s, o, f, 3) for s, o in zip(sizes, oc))  # layer_rn
    for k, s in enumerate(sizes):                   # fusion blocks 1..4
        units = 1 if k == 3 else 2
        total += units * 2 * _conv(*s, f, f, 3) + _conv(*s, f, f, 1)
    h1, w1 = 2 * sizes[0][0], 2 * sizes[0][1]
    total += _conv(h1, w1, f, f // 2, 3)                        # output_conv1
    total += _conv(ph * 14, pw * 14, f // 2, 32, 3)             # head 3x3
    total += _conv(ph * 14, pw * 14, 32, 1, 1)                  # head 1x1
    return total


def forward_flops(cfg: dict, net_hw: tuple[int, int]) -> float:
    return encoder_flops(cfg, net_hw) + decoder_flops(cfg, net_hw)


def attn_fwd_work(b: int, n: int, h: int, d: int) -> tuple[float, float]:
    flops = 4.0 * b * h * n * n * d
    nbytes = 4 * b * n * h * d * BF16_BYTES + b * h * n * F32_BYTES
    return flops, nbytes


def attn_bwd_work(b: int, n: int, h: int, d: int) -> tuple[float, float]:
    flops = 2.5 * attn_fwd_work(b, n, h, d)[0]
    nbytes = 8 * b * n * h * d * BF16_BYTES + b * h * n * F32_BYTES
    return flops, nbytes


def resize_work(b: int, c: int, h: int, w: int, h2: int, w2: int,
                elem_bytes: int = BF16_BYTES) -> tuple[float, float]:
    return 0.0, float(b * c * (h * w + h2 * w2) * elem_bytes)


def dpt_resizes(cfg: dict, net_hw: tuple[int, int], batch: int
                ) -> list[tuple[int, int, int, int, int, int]]:
    """(B, C, h, w, h2, w2) of the head's five align-corners resizes, in
    the order they run."""
    f = cfg["features"]
    s1, s2, s3, s4 = decoder_sizes(cfg, net_hw)
    ph, pw = grid(cfg, net_hw)
    up = (2 * s1[0], 2 * s1[1])
    return [(batch, f, *s4, *s3), (batch, f, *s3, *s2),
            (batch, f, *s2, *s1), (batch, f, *s1, *up),
            (batch, f // 2, *up, ph * 14, pw * 14)]


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take for the work: the larger of
    its operations at the bf16 peak and its bytes at HBM's peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def roofline_share(calls, work, run) -> float | None:
    """The least time of ``calls``' work (``work(args, run)`` -> (flops,
    bytes)) over their kernels' device seconds, in percent; None with no
    call to read."""
    if not calls:
        return None
    least = sum(least_seconds(*work(args, run)) for args, _ in calls)
    spent = sum(secs for _, secs in calls)
    return 100.0 * least / spent if spent > 0 else None
