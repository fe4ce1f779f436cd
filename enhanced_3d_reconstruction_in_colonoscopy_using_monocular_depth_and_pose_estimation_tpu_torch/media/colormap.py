"""Depth visualization: Spectral colormaps, grayscale, composites.

The port of the JAX package's ``media/colormap.py`` (the reference's
``depth_to_heatmap``, Spectral_r, and its ``run.py`` output path: min-max
normalize -> uint8 -> grayscale or Spectral colormap -> optional
side-by-side with a white divider), without matplotlib: matplotlib's
256-entry ``Spectral`` and ``Spectral_r`` lookup tables are kept here as
``(lut[:, :3] * 255).astype(uint8)``, generated once from matplotlib 3.10.
A uint8 input indexes the table as matplotlib does; a float input in
[0, 1] picks entry ``int(x * 256)`` (255 at x == 1), which is also
matplotlib's lookup (its tables are not interpolated between entries), so
both renderings equal the JAX package's.
"""

from __future__ import annotations

import numpy as np

_SPECTRAL_HEX = (
    "9e0142a00342a20543a40843a60a44a80c44aa0f45ad1145af1446b11646b31847b51b47"
    "b71d48ba2048bc2249be2449c0274ac2294ac42c4bc62e4bc9304ccb334ccd354dcf384d"
    "d13a4ed33c4ed53e4ed6404ed8424dd9444dda464cdb484cdc494bde4b4bdf4d4be04f4a"
    "e1514ae25349e45549e55648e65848e75a47e95c47ea5e46eb6046ec6145ed6345ef6544"
    "f06744f16943f26b43f46d43f46f44f47245f57446f57747f57948f67c4af67e4bf6814c"
    "f7834df7864ef7894ff88b51f88e52f89053f99354f99555fa9856fa9a58fa9d59fb9f5a"
    "fba25bfba55cfca75efcaa5ffcac60fdae61fdb063fdb265fdb466fdb668fdb86afdba6b"
    "fdbc6dfdbe6efdc070fdc272fdc473fdc675fdc877fdca78fdcc7afdce7cfdd07dfdd27f"
    "fdd481fdd682fdd884fdda86fddc87fdde89fee08bfee18dfee28ffee391fee493fee695"
    "fee797fee899fee99bfeea9dfeec9ffeeda1feeea3feefa5fef1a7fef2a9fef3abfef4ad"
    "fef5affef7b1fef8b3fef9b5fefab7fefbb9fefdbbfefebdfefebefdfebcfcfebbfbfdb9"
    "fafdb8f9fcb6f8fcb5f7fcb3f6fbb2f5fbb0f4faaef3faadf2faabf1f9aaf0f9a8eff8a7"
    "eef8a5edf8a4ecf7a2ebf7a1eaf69fe9f69ee8f69ce7f59be6f599e6f598e3f498e1f398"
    "dff299dcf199daf09ad8ef9ad5ee9bd3ed9bd1ec9cceeb9cccea9dcae99dc7e89ec5e79e"
    "c3e69fc0e59fbee5a0bce4a0bae3a0b7e2a1b5e1a1b3e0a2b0dfa2aedea3acdda3a9dca4"
    "a6dba4a4daa4a1d9a49ed8a49cd7a499d6a496d5a494d4a491d2a48ed1a48bd0a489cfa4"
    "86cea483cda481cca47ecba47bcaa478c9a476c8a473c7a470c6a46ec5a46bc4a468c3a4"
    "66c2a563bfa561bda65fbba75db8a85bb6a959b4aa57b2ab55afac53adad51abae4fa8af"
    "4da6b04ba4b149a2b2479fb3459db4439bb54199b53f96b63d94b73b92b8398fb9378dba"
    "358bbb3389bc3286bc3484bb3682ba3880b9397db83b7bb73d79b63e77b54075b44272b2"
    "4470b1456eb0476caf4969ae4b67ad4c65ac4e63ab5060aa515ea9535ca8555aa75757a6"
    "5855a55a53a45c51a35e4fa2"
)
_SPECTRAL_R_HEX = (
    "5e4fa25c51a35a53a45855a55757a6555aa7535ca8515ea95060aa4e63ab4c65ac4b67ad"
    "4969ae476caf456eb04470b14272b24075b43e77b53d79b63b7bb7397db83880b93682ba"
    "3484bb3286bc3389bc358bbb378dba398fb93b92b83d94b73f96b64199b5439bb5459db4"
    "479fb349a2b24ba4b14da6b04fa8af51abae53adad55afac57b2ab59b4aa5bb6a95db8a8"
    "5fbba761bda663bfa566c2a568c3a46bc4a46ec5a470c6a473c7a476c8a478c9a47bcaa4"
    "7ecba481cca483cda486cea489cfa48bd0a48ed1a491d2a494d4a496d5a499d6a49cd7a4"
    "9ed8a4a1d9a4a4daa4a6dba4a9dca4acdda3aedea3b0dfa2b3e0a2b5e1a1b7e2a1bae3a0"
    "bce4a0bee5a0c0e59fc3e69fc5e79ec7e89ecae99dccea9dceeb9cd1ec9cd3ed9bd5ee9b"
    "d8ef9adaf09adcf199dff299e1f398e3f498e6f598e6f599e7f59be8f69ce9f69eeaf69f"
    "ebf7a1ecf7a2edf8a4eef8a5eff8a7f0f9a8f1f9aaf2faabf3faadf4faaef5fbb0f6fbb2"
    "f7fcb3f8fcb5f9fcb6fafdb8fbfdb9fcfebbfdfebcfefebefefebdfefdbbfefbb9fefab7"
    "fef9b5fef8b3fef7b1fef5affef4adfef3abfef2a9fef1a7feefa5feeea3feeda1feec9f"
    "feea9dfee99bfee899fee797fee695fee493fee391fee28ffee18dfee08bfdde89fddc87"
    "fdda86fdd884fdd682fdd481fdd27ffdd07dfdce7cfdcc7afdca78fdc877fdc675fdc473"
    "fdc272fdc070fdbe6ffdbc6dfdba6bfdb86afdb668fdb466fdb265fdb063fdae61fcac60"
    "fcaa5ffca75efba55cfba25bfb9f5afa9d59fa9a58fa9857f99555f99354f89053f88e52"
    "f88b51f7894ff7864ef7834df6814cf67e4bf67c4af57948f57747f57446f47245f46f44"
    "f46d43f26b43f16943f06744ef6544ed6345ec6145eb6046ea5e46e95c47e75a47e65848"
    "e55648e45549e25349e1514ae04f4adf4d4bde4b4bdc494bdb484cda464cd9444dd8424d"
    "d6404ed53e4ed33c4ed13a4ecf384dcd354dcb334cc9304cc62e4bc42c4bc2294ac0274a"
    "be2449bc2249ba2048b71d48b51b47b31847b11646af1446ad1145aa0f45a80c44a60a44"
    "a40843a20543a003429e0142"
)


def _table(hex_rgb: str) -> np.ndarray:
    return np.frombuffer(bytes.fromhex(hex_rgb), np.uint8).reshape(256, 3)


SPECTRAL = _table(_SPECTRAL_HEX)
SPECTRAL_R = _table(_SPECTRAL_R_HEX)


def _minmax_uint8(depth: np.ndarray) -> np.ndarray:
    lo, hi = float(np.min(depth)), float(np.max(depth))
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    return ((depth - lo) * scale).astype(np.uint8)


def _lookup_float(table: np.ndarray, x: np.ndarray) -> np.ndarray:
    """matplotlib's lookup of floats in [0, 1]: entry int(x * 256), the
    last one at x == 1."""
    xa = x * 256
    xa[xa == 256] = 255
    return table[np.clip(xa, 0, 255).astype(int)]


def depth_to_heatmap(depth: np.ndarray) -> np.ndarray:
    """Min-max normalized Spectral_r heatmap, RGB uint8."""
    lo, hi = float(np.min(depth)), float(np.max(depth))
    norm = (depth - lo) / (hi - lo) if hi > lo else np.zeros_like(depth)
    return _lookup_float(SPECTRAL_R, norm)


def colorize_depth(depth: np.ndarray, grayscale: bool = False,
                   bgr: bool = True) -> np.ndarray:
    """run.py-style rendering: minmax->uint8, gray 3-channel or Spectral.

    Returns BGR by default (cv2.imwrite convention, matching run.py).
    """
    d8 = _minmax_uint8(depth)
    if grayscale:
        return np.repeat(d8[..., None], 3, axis=-1)
    rgb = SPECTRAL[d8]
    return rgb[:, :, ::-1] if bgr else rgb


def side_by_side(raw_bgr: np.ndarray, rendered_bgr: np.ndarray,
                 gap: int = 50) -> np.ndarray:
    """Original frame | white divider | rendering (run.py)."""
    divider = np.full((raw_bgr.shape[0], gap, 3), 255, np.uint8)
    return np.concatenate([raw_bgr, divider, rendered_bgr], axis=1)
