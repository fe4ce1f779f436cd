"""Operations and bytes of Video Depth Anything's work, from the shapes of
its configuration alone (``counts.py`` for what it shares with DAv2).

- ``temporal_flops``: multiply-adds x 2 of one frame's four motion
  modules at T frames a clip. A module of width C over S locations costs
  per location 22 C^2 multiply-adds of projections (``proj_in``, two
  attention blocks' q, k, v and ``to_out``, the GEGLU's C -> 8C and
  4C -> C, ``proj_out``) and 4 T C of attention (two blocks, q k^T and
  p v over T frames): 44 C^2 + 8 T C operations. The norms, the GELU
  gate and the regrouping are bound by bytes and left out, as
  ``counts.py`` leaves them out.
- ``window_flops``: a window's positions x (DAv2's forward,
  ``counts.forward_flops``, + ``temporal_flops``).
- ``temporal_attn_work``: ``e3d::temporal_attn`` over (B*T, S, 3, H, D)
  in bf16: 4 S H T^2 D operations a clip; bytes are q, k, v and o each
  read or written once.
"""

from __future__ import annotations

from .counts import BF16_BYTES, decoder_sizes, forward_flops, grid


def module_sites(cfg: dict, net_hw: tuple[int, int]
                 ) -> list[tuple[int, int]]:
    """(width, locations) of the four motion modules: ``layer_3`` and
    ``path_4`` on the patch grid, ``layer_4`` on the stride-2 grid,
    ``path_3`` on twice the patch grid."""
    ph, pw = grid(cfg, net_hw)
    h4, w4 = decoder_sizes(cfg, net_hw)[3]
    widths = cfg["temporal"]["widths"]
    return [(widths[0], ph * pw), (widths[1], h4 * w4),
            (widths[2], ph * pw), (widths[3], 4 * ph * pw)]


def temporal_flops(cfg: dict, net_hw: tuple[int, int], frames: int) -> float:
    return sum(s * (44.0 * c * c + 8.0 * frames * c)
               for c, s in module_sites(cfg, net_hw))


def window_flops(cfg: dict, net_hw: tuple[int, int],
                 positions: int | None = None) -> float:
    t = int(cfg["window"])
    positions = t if positions is None else positions
    return positions * (forward_flops(cfg, net_hw)
                        + temporal_flops(cfg, net_hw, t))


def temporal_attn_work(bt: int, s: int, h: int, d: int, frames: int
                       ) -> tuple[float, float]:
    flops = 4.0 * (bt // frames) * s * h * frames * frames * d
    nbytes = 4.0 * bt * s * h * d * BF16_BYTES
    return flops, nbytes
