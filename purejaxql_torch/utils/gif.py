"""Dependency-free animated GIF writer for policy videos (a numpy-only
copy of purejaxql_tpu/utils/gif.py, writing the same bytes).

A GIF89a encoder written against the spec, its LZW stream in "literal"
mode: every pixel emitted as its own code, with a clear code before the
code width would grow. That is valid LZW and keeps the encoder short at the
cost of file size; the grid games' frames are small, so the files stay
small too.
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np

# channel colors for grid-game frames (rgb)
_CHANNEL_COLORS = [
    (64, 160, 255),   # 0: player / paddle — blue
    (240, 80, 80),    # 1: enemy / ball — red
    (250, 200, 80),   # 2: trail / secondary — amber
    (120, 220, 120),  # 3: gold / bricks — green
    (200, 120, 240),  # 4: purple
    (90, 220, 220),   # 5: cyan
    (255, 140, 40),   # 6: orange
    (180, 180, 180),  # 7: grey
    (110, 110, 240),  # 8: indigo
    (240, 240, 120),  # 9: pale yellow
]
_BG = (16, 16, 24)


def grid_obs_to_indexed(obs: np.ndarray, scale: int = 8) -> np.ndarray:
    """(H, W, C) one-hot-ish grid obs -> (H*scale, W*scale) palette indices.

    Cell color = highest active channel + 1; 0 is the background.
    """
    H, W, C = obs.shape
    active = obs > 0.5
    # highest-priority (lowest-index) active channel wins
    idx = np.zeros((H, W), np.uint8)
    for c in range(C - 1, -1, -1):
        idx = np.where(active[..., c], c + 1, idx)
    img = np.kron(idx, np.ones((scale, scale), np.uint8))
    return img


def palette_for_channels(num_channels: int) -> list:
    colors = [_BG] + [
        _CHANNEL_COLORS[c % len(_CHANNEL_COLORS)] for c in range(num_channels)
    ]
    return colors


def write_gif(
    path: str,
    frames: Sequence[np.ndarray],
    palette: Sequence[tuple],
    delay_cs: int = 8,
) -> None:
    """Write an animated GIF.

    Args:
      path: output file.
      frames: sequence of (H, W) uint8 arrays of palette indices.
      palette: list of (r, g, b); padded to the next power of two <= 256.
      delay_cs: per-frame delay in centiseconds.
    """
    frames = [np.asarray(f, np.uint8) for f in frames]
    H, W = frames[0].shape
    # pad palette to a power of two (>= 4 so min LZW code size >= 2)
    size = 4
    while size < len(palette):
        size *= 2
    pal = list(palette) + [(0, 0, 0)] * (size - len(palette))
    color_bits = max(2, (size - 1).bit_length())

    out = bytearray()
    out += b"GIF89a"
    out += struct.pack("<HHBBB", W, H, 0xF0 | (color_bits - 1), 0, 0)
    for r, g, b in pal:
        out += bytes((r, g, b))
    # loop forever (Netscape application extension)
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"

    min_code_size = max(2, color_bits)
    clear = 1 << min_code_size
    end = clear + 1

    for frame in frames:
        assert frame.shape == (H, W)
        out += b"\x21\xf9\x04\x04" + struct.pack("<H", delay_cs) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHH", 0, 0, W, H) + b"\x00"
        out += bytes([min_code_size])

        # LZW literal mode: CLEAR, then each pixel as its own code, with a
        # CLEAR re-emitted before the code width would have to grow
        bits = bytearray()
        acc = 0
        nbits = 0
        code_width = min_code_size + 1

        def emit(code):
            nonlocal acc, nbits
            acc |= code << nbits
            nbits += code_width
            while nbits >= 8:
                bits.append(acc & 0xFF)
                acc >>= 8
                nbits -= 8

        emit(clear)
        budget = (1 << code_width) - end - 2  # codes before width growth
        count = 0
        for px in frame.reshape(-1):
            if count >= budget:
                emit(clear)
                count = 0
            emit(int(px))
            count += 1
        emit(end)
        if nbits:
            bits.append(acc & 0xFF)

        # packetize into <=255-byte sub-blocks
        for i in range(0, len(bits), 255):
            chunk = bits[i : i + 255]
            out += bytes([len(chunk)]) + bytes(chunk)
        out += b"\x00"

    out += b"\x3b"
    with open(path, "wb") as f:
        f.write(out)


def render_grid_episode_gif(
    path: str, obs_traj: np.ndarray, scale: int = 8, delay_cs: int = 8
) -> None:
    """Render a (T, H, W, C) grid-obs trajectory to an animated GIF."""
    obs_traj = np.asarray(obs_traj)
    assert obs_traj.ndim == 4, "need (T, H, W, C) grid observations"
    frames = [grid_obs_to_indexed(f, scale) for f in obs_traj]
    write_gif(path, frames, palette_for_channels(obs_traj.shape[-1]), delay_cs)
